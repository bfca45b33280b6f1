"""The least time of the port's own kernels, counted from the cell's shapes.

``bound_ms`` and the ``*_bound`` functions are copies of ``chip_smoke.py``'s
(``tests`` under ``portbench/tests`` hold them equal on the same inputs);
``bn_sites`` takes the configuration as a dict. A bound is the larger of
the operations over the unit's peak and the bytes over the memory rate
(H100 SXM, NVIDIA's data sheet: 67 TFLOP/s f32 on the CUDA cores, 989 in
bf16 and 495 in TF32 on the tensor cores, 3.35 TB/s of HBM3).

:func:`unit_bounds` lists, by kernel family, the bound of one eval forward
or one training step at batch B, from the calls the model makes:

- FPS at the five SA layers; the ball query at the same five, its
  operations counted at ``nsample`` points a query (the least a query can
  scan: its real scan depends on the cloud, so this undercounts);
- batch norm at the 23 sites (eval: K2, with the pool at the five SA last
  widths; training: K1-K4, K4 with the prologue's cotangent sums; mixed
  precision's split first layers at sa2-sa4 through ``split_bounds``;
  bf16 sites at two bytes an element);
- the scatter of every training gather whose rows carry gradient (sa2-sa4
  over the features, the proposal layer over coordinates and features);
- the head (decode with the IoU self-matrix, and the greedy's bytes: the
  IoUs it reads depend on the candidates, so they are not counted);
- mixed precision's weight casts: the bf16 layers' weights read in f32 and
  written in bf16, and their gradients back, once each a step.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
PEAK_BF16_FLOPS = 989e12  # H100 SXM, bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_FLOPS = {"float32": PEAK_F32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}


def bound_ms(ops: float, nbytes: float) -> tuple[float, float]:
    """(ms of the operations at the f32 peak, ms of the bytes at the memory
    rate): the bound is the larger."""
    return ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def fps_bound(B, N, npoint):
    return bound_ms(10.0 * (npoint - 1) * N * B, B * N * 12.0 + B * npoint * 4.0)


def ballquery_bound(xyz, q, nsample, idx, cnt):
    B, N, _ = xyz.shape
    M = q.shape[1]
    # points a query tests: up to its nsample-th hit, or all N
    last = idx[..., nsample - 1].long() + 1
    scanned = float(last.where(cnt >= nsample, N).sum())
    return bound_ms(9.0 * scanned, (B * N + B * M) * 12.0 + B * M * (nsample + 1) * 4.0)


def ballquery_shape_bound(B, N, M, nsample):
    """:func:`ballquery_bound` with each query scanning its least, ``nsample``
    points."""
    return bound_ms(9.0 * B * M * min(nsample, N), (B * N + B * M) * 12.0 + B * M * (nsample + 1) * 4.0)


def scatter_bound(g, idx, N):
    B, K, C = g.shape
    valid = float(((idx >= 0) & (idx < N)).sum())
    return bound_ms(valid * C, (B * K * C + B * K + B * N * C) * 4.0)


def scatter_shape_bound(B, K, C, N):
    """:func:`scatter_bound` with every index in range."""
    return bound_ms(float(B * K) * C, (B * K * C + B * K + B * N * C) * 4.0)


def samlp_bound(h_all, idx, sh0, s0, layers, precision="f32"):
    """((tensor-core ms, bytes ms), f32 CUDA-core ms); the tensor cores at 3 x
    2 operations a multiply-add in TF32 (3xTF32, "f32") or 2 in bf16."""
    B, N, w0 = h_all.shape
    _, M, S = idx.shape
    rows = B * M * S
    widths = [w0] + [w.shape[1] for w, _, _ in layers]
    macs = sum(rows * w_in * w_out for w_in, w_out in zip(widths, widths[1:]))
    f32_ops = 2.0 * macs + 3.0 * rows * w0 + rows * widths[-1] + sum(3.0 * rows * w for w in widths[1:])
    params = sum(w.numel() + s.numel() + t.numel() for w, s, t in layers) + s0.numel()
    nbytes = (h_all.numel() + sh0.numel() + params + B * M * widths[-1]) * 4.0 + idx.numel() * 4.0
    _, bytes_ms = bound_ms(0.0, nbytes)
    tc_ms = (3.0 * 2.0 * macs / PEAK_TF32_FLOPS if precision == "f32" else 2.0 * macs / PEAK_BF16_FLOPS) * 1e3
    return (tc_ms, bytes_ms), f32_ops / PEAK_F32_FLOPS * 1e3


def nms_bound(B, N, reads):
    """The greedy's least time: the scores (4 bytes), the objectness (8) and
    the keep mask (1) a box, the ``reads`` IoUs this run's candidates need
    (4 bytes each); one threshold test an IoU read and one comparison a
    pair of boxes to rank them."""
    return bound_ms(float(reads + B * N * N), reads * 4.0 + B * N * 13.0)


DECODE_OPS = 9 + 3 + 6 + 31 + 3 + 8 * 9


def decode_bound(B, P, C, NH, NS, NC):
    """The decode's least time: the head's channels and the proposal centres
    read (C + 3 floats a proposal), the corners, centre, size, heading and
    score written (32 floats) and the two classes (int32); DECODE_OPS and 2
    a compared score a proposal at the f32 peak."""
    return bound_ms(float((DECODE_OPS + 2 * (NH + NS + NC)) * B * P), B * P * (C + 3 + 32 + 2) * 4.0)


def decode_iou_bound(B, P, C, NH, NS, NC):
    """The fused head kernel's least time: the decode's (``decode_bound``)
    and the IoU self-matrix's pairs and boxes (``iou_bound``) added, its
    bytes the decode's and the (B, P, P) matrix written (the corners are
    never read)."""
    d_ops, d_bytes = decode_bound(B, P, C, NH, NS, NC)
    i_ops, _ = iou_bound(B, P, P, self_matrix=True)
    return d_ops + i_ops, d_bytes + B * P * P * 4.0 / PEAK_BYTES * 1e3


IOU_PAIR_OPS = 2 * 419 + 19
IOU_BOX_OPS = 18 + 8 + 3


def iou_bound(B, N, M, self_matrix=False):
    """The IoU matrix's least time: IOU_PAIR_OPS a pair and IOU_BOX_OPS a box
    at the f32 peak; the corners read (96 bytes a box) and the matrix
    written (4 bytes a pair). The self-matrix (the same corners twice, N ==
    M) needs N (N + 1) / 2 pairs, its N boxes read once, the whole matrix
    written."""
    if self_matrix:
        return bound_ms(IOU_PAIR_OPS * B * N * (N + 1) / 2 + IOU_BOX_OPS * B * N, B * N * 96.0 + B * N * N * 4.0)
    return bound_ms(IOU_PAIR_OPS * B * N * M + IOU_BOX_OPS * B * (N + M), B * (N + M) * 96.0 + B * N * M * 4.0)


def bn_sites(cfg: dict):
    """(layer, rows a scene, channels, prologue, pooled) of each batch norm
    + ReLU of a forward, in the layer list's order: an SA layer's first
    width takes the centred prologue ("centre"), every other site the dense
    bias ("bias"); an SA layer's last width is pooled over its ``nsample``
    slots."""
    sites = []

    def sa(name, rows, mlp):
        sites.extend((name, rows, w, "centre" if j == 0 else "bias", j == len(mlp) - 1) for j, w in enumerate(mlp))

    for i, mlp in enumerate(cfg["sa_mlps"]):
        sa(f"sa{i + 1}", cfg["sa_npoints"][i] * cfg["sa_nsamples"][i], mlp)
    for i, mlp in enumerate(cfg["fp_mlps"]):  # fp1 at sa3's points, fp2 at sa2's
        sites += [(f"fp{i + 1}", cfg["sa_npoints"][2 - i], w, "bias", False) for w in mlp]
    sites += [("voting", cfg["sa_npoints"][1], w, "bias", False) for w in cfg["vote_units"][:-1]]
    sa("proposal", cfg["proposal_num"] * cfg["proposal_nsample"], cfg["proposal_mlp"])
    sites += [("mlp2", cfg["proposal_num"], w, "bias", False) for w in cfg["proposal_mlp2_hidden"]]
    return sites


def bn_slots(cfg: dict, layer):
    """The slots a ball (S) of an SA layer's pool."""
    return cfg["proposal_nsample"] if layer == "proposal" else cfg["sa_nsamples"][int(layer[2:]) - 1]


def bn_bounds(R, C, es_in, es_out, S=1, prologue=None, pooled=False):
    """(ops ms, bytes ms) of K1-K4 at R x C (units of S rows): each input read
    once, each output written once (the per-channel vectors 4 bytes a
    channel); the prologue reads the dense bias (C) and the centre's rows
    (R / S x C) and adds one operation an element for each; at a pooled
    site K2 writes the maxima and int32 counts (R / S x C) in place of y and
    K3 and K4 read them and the pooled cotangent in place of dy. f32
    operations an element: K1 3 (an add, a square, an add), K2 4 (subtract,
    multiply, add, max; pooled 2 more, the compare and the count), K3 and
    K4 9 (K2's three, the mask's compare and select, and the subtract,
    multiply and two adds of the sums or of dx; pooled 3 more: the compare,
    the division by the count, the select). K4 with the epilogue: 2 adds an
    element more (the unit's sum, the bias's), and corr's cotangent (R / S x
    C) and the dense bias's (C f32) written. K2 with the statistics' end
    (a data-parallel group's): K2's (or its pool variant's), plus the two
    f64 sums and the weight read, the running statistics read and written
    and the (4, C) statistics written, ~20 operations a channel."""
    n = float(R) * C
    G = float(R) // S
    pro_ops = n * ((prologue == "centre") + (prologue is not None))
    pro_bytes = (G * C * es_in if prologue == "centre" else 0) + (C * es_in if prologue else 0)
    pool_out = G * C * (es_out + 4)
    dy = G * C * (2 * es_out + 4) if pooled else n * es_out
    k4_ops, k4_bytes = (12 if pooled else 9) * n + pro_ops, 2 * n * es_in + dy + pro_bytes + 20 * C
    epi_bytes = (G * C * es_in if prologue == "centre" else 0) + (4 * C if prologue else 0)
    k2_ops, k2_bytes = (6 if pooled else 4) * n + pro_ops, n * es_in + (pool_out if pooled else n * es_out) + pro_bytes
    return {"bn_stats": bound_ms(3 * n + pro_ops, n * es_in + pro_bytes + 8 * C),
            "bn_apply": bound_ms(k2_ops, k2_bytes + 12 * C),
            "bn_bwd_reduce": bound_ms((12 if pooled else 9) * n + pro_ops, n * es_in + dy + pro_bytes + 20 * C),
            "bn_bwd_apply": bound_ms(k4_ops, k4_bytes),
            "bn_bwd_apply_sums": bound_ms(k4_ops + (2 * n if prologue else 0), k4_bytes + epi_bytes),
            "bn_apply_group": bound_ms(k2_ops + 20 * C, k2_bytes + 4 * C + 52 * C)}


def split_bounds(R, S, C, es):
    """(ops ms, bytes ms) of the split kernels at R x C in units of S rows:
    h read (and dy, y or dx as the stage reads or writes them), the
    coordinates (12 bytes a row), the centres (12 a unit), W3 and the dense
    bias; the prologue's f32 operations an element: the row's dot3 (3
    multiplies, 2 adds), the subtraction, the add of h and of the bias (8),
    and the centre's dot3 (5) once a unit and channel; then K1 3, K2 4, K3
    9, K4 9 more an element (phase 32's counts), and K4's epilogue 7 (the
    bias's add, W3's three products and adds) and W3's and the bias's
    cotangents written."""
    n, G = float(R) * C, float(R) // S
    pro_ops = 8 * n + 5 * G * C
    pro_bytes = n * es + 12 * R + 12 * G + 16 * C
    return {"bn_split_stats": bound_ms(3 * n + pro_ops, pro_bytes + 16 * C),
            "bn_split_apply": bound_ms(4 * n + pro_ops, pro_bytes + n * es + 12 * C),
            "bn_split_bwd_reduce": bound_ms(9 * n + pro_ops, pro_bytes + n * es + 20 * C),
            "bn_split_bwd_apply": bound_ms(16 * n + pro_ops, pro_bytes + 2 * n * es + 36 * C)}


def _sa_shapes(cfg: dict) -> List[Tuple[str, int, int, int]]:
    """(layer, points in, centres, slots) of the five SA layers' FPS and ball
    query (the proposal layer samples the seeds and queries the votes: as
    many of each)."""
    n_in = [cfg["point_num"]] + list(cfg["sa_npoints"][:3])
    out = [(f"sa{i + 1}", n_in[i], cfg["sa_npoints"][i], cfg["sa_nsamples"][i]) for i in range(4)]
    return out + [("proposal", cfg["sa_npoints"][1], cfg["proposal_num"], cfg["proposal_nsample"])]


def unit_bounds(cfg: dict, layer_dtypes: Dict[str, str], B: int, train: bool) -> Dict[str, float]:
    """{kernel family: least ms} of one eval forward (``train`` False) or one
    training step at batch ``B`` (see the module docstring)."""
    out: Dict[str, float] = {}

    def add(family, pair):
        out[family] = out.get(family, 0.0) + max(pair)

    for _, n_in, m, s in _sa_shapes(cfg):
        add("fps", fps_bound(B, n_in, m))
        add("ballquery", ballquery_shape_bound(B, n_in, m, s))
    for layer, rows, C, prologue, pooled in bn_sites(cfg):
        es = 2 if layer_dtypes.get(layer, "float32") == "bfloat16" else 4
        S = bn_slots(cfg, layer) if layer.startswith("sa") or layer == "proposal" else 1
        R = B * rows
        split = es == 2 and layer.startswith("sa") and prologue == "centre"
        if split:
            sb = split_bounds(R, S, C, es)
            stages = ("bn_split_stats", "bn_split_bwd_reduce", "bn_split_bwd_apply") if train else ()
            for k in stages + ("bn_split_apply",):
                add("batchnorm", sb[k])
            continue
        bb = bn_bounds(R, C, es, es, S, prologue, pooled)
        add("batchnorm", bb["bn_apply"])
        if train:
            for k in ("bn_stats", "bn_bwd_reduce", "bn_bwd_apply_sums"):
                add("batchnorm", bb[k])
    if train:
        n_in = [cfg["point_num"]] + list(cfg["sa_npoints"][:3])
        for i in (1, 2, 3):  # the features' gather of sa2-sa4
            add("scatter", scatter_shape_bound(B, cfg["sa_npoints"][i] * cfg["sa_nsamples"][i],
                                               cfg["sa_mlps"][i - 1][-1], n_in[i]))
        seed_c = cfg["fp_mlps"][1][-1]
        add("scatter", scatter_shape_bound(B, cfg["proposal_num"] * cfg["proposal_nsample"], 3 + seed_c,
                                           cfg["sa_npoints"][1]))
        low = [f"sa{i + 1}" for i in range(4) if layer_dtypes.get(f"sa{i + 1}", "float32") == "bfloat16"]
        if low:
            elems = 0
            cin = 3
            for i, widths in enumerate(cfg["sa_mlps"]):
                c = 3 + cin
                for w in widths:
                    if f"sa{i + 1}" in low:
                        elems += c * w
                    c = w
                cin = widths[-1]
            add("cast", bound_ms(0.0, elems * 6.0 * 2))  # f32 -> bf16 copies, and their gradients back
    else:
        NH, NS, NC = cfg["num_heading_bin"], cfg["num_size_cluster"], cfg["num_class"]
        P = cfg["proposal_num"]
        add("head", decode_iou_bound(B, P, 5 + 2 * NH + 4 * NS + NC, NH, NS, NC))
        add("head", nms_bound(B, P, 0))  # the greedy without the IoUs it reads (they depend on the candidates)
    return out
