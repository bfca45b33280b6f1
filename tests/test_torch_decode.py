"""The decode of the port's detection head against the JAX package's, on the
CPU.

``decode_proposals`` runs the kernel of ``csrc/decode.cu`` on a CUDA tensor
and ``decode_proposals_plain`` on a CPU tensor; both state every float
operation and its order, with sin and cos written out, so that the card and
the CPU compute the same floats (the kernel against the plain version is in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 31). Here:
- the stated sin and cos (a numpy transcription, and the plain version)
  within ``SINCOS_ULPS`` of float64 on a dense grid of [0, 2 pi] and every
  float near its multiples of pi/2;
- a numpy transcription of the kernel's arithmetic equal, float for float,
  to the plain version;
- the plain version against JAX's ``decode_proposals`` on the same end
  points within ``REL`` of scale (``tests/test_torch_model.py``'s), the
  classes equal and ``heading_pred`` bit-equal to ``jnp.mod``'s: headings at
  0, near and at 2 pi, negative residuals and every heading bin;
- ``predict_boxes`` against JAX's on the same end points;
- the fused decode + IoU self-matrix (``decode_with_iou``, one launch on
  the card): its plain route is ``decode_proposals_plain`` and the IoU's
  plain version bit for bit, and it matches JAX's ``decode_proposals`` and
  ``box3d_iou_matrix`` within ``REL``.

JAX is imported inside the tests: ``tests/test_torch_cuda.py`` takes this
file's end points on the card's machine, which has no JAX.
"""

import math

import numpy as np
import pytest
import torch

from votenet_tpu_torch.config import default_config, tiny_config
from votenet_tpu_torch.data.geometry import CLASS_MEAN_SIZE
from votenet_tpu_torch.models import decode as dec
from votenet_tpu_torch.models.decode import (decode_proposals, decode_proposals_plain, decode_with_iou, predict_boxes,
                                             sincos_plain)
from votenet_tpu_torch.ops.cuda.decode import decode_iou_cuda, decode_proposals_cuda, heading_scale
from votenet_tpu_torch.ops.iou3d import box3d_iou_matrix_plain

REL = 2e-5  # tests/test_torch_model.py's: the two frameworks' f32 sums and FMAs
SINCOS_ULPS = 2.0  # the stated sin and cos against float64; 1.49 on this file's grid
F = np.float32


def close(got, want, rel=REL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


def bits(a):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.ascontiguousarray(a, F).view(np.int32)


# ---------------------------------------------------- the kernel in numpy

def np_sincos(x):
    """csrc/decode.cu's sincos_stated, one f32 rounding an operation."""
    x = np.asarray(x, F)
    with np.errstate(invalid="ignore"):  # inf and NaN give NaN, as on the card
        k = np.rint(x * F(dec.TWO_OVER_PI))
        r = x
        for part in dec.PIO2_PARTS:
            r = r - k * F(part)
        z = r * r
        S0, S1, S2 = (F(c) for c in dec.SIN_COEFFS)
        C0, C1, C2 = (F(c) for c in dec.COS_COEFFS)
        p = z * S0 + S1
        p = p * z + S2
        p = (p * z) * r
        s = r + p
        q = z * C0 + C1
        q = q * z + C2
        q = (q * z) * z
        q = q - z * F(0.5)
        c = q + F(1)
    quad = np.where(np.isfinite(k), k, 0).astype(np.int64) & 3
    a, b = np.where(quad & 1, c, s), np.where(quad & 1, s, c)
    return np.where(quad & 2, -a, a).astype(F), np.where((quad + 1) & 2, -b, b).astype(F)


def np_argmax_first(v):
    """The kernel's argmax: the first maximum, a NaN above every number."""
    best = np.zeros(v.shape[:-1], np.int64)
    m = v[..., 0].copy()
    for k in range(1, v.shape[-1]):
        x = v[..., k]
        take = (x > m) | (np.isnan(x) & ~np.isnan(m))
        best = np.where(take, k, best)
        m = np.where(take, x, m)
    return best


def np_decode(out, xyz, NH, NS, NC):
    """csrc/decode.cu's decode_kernel for every proposal at once."""
    out, xyz = np.asarray(out, F), np.asarray(xyz, F)
    C = out.shape[-1]
    hc = np_argmax_first(out[..., 5:5 + NH])
    sc = np_argmax_first(out[..., 5 + 2 * NH:5 + 2 * NH + NS])
    cc = np_argmax_first(out[..., C - NC:])
    take = lambda a, i: np.take_along_axis(a, i[..., None], -1)[..., 0]  # noqa: E731
    res = np.stack([take(out[..., 5 + 2 * NH + NS + d:5 + 2 * NH + 4 * NS:3], sc) for d in range(3)], -1)
    v = F(1) + res
    v = np.where(v < F(dec.MIN_SCALE), F(dec.MIN_SCALE), v)
    size = CLASS_MEAN_SIZE.astype(F)[sc] * v
    center = xyz + out[..., 2:5]
    h = hc.astype(F) * F(2) + take(out[..., 5 + NH:5 + 2 * NH], hc)
    h = np.fmod(h * F(heading_scale(NH)), F(dec.TWO_PI))
    h = np.where(h < 0, h + F(dec.TWO_PI), h)
    s, c = np_sincos(h)
    hl, hw, hh = (F(0.5) * size[..., d] for d in range(3))
    corners = []
    for k in range(8):
        x = -hl if k & 2 else hl
        y = hh if k < 4 else -hh
        z = -hw if (k + 1) & 2 else hw
        corners.append([(c * x + s * z) + center[..., 0], y + center[..., 1], (c * z - s * x) + center[..., 2]])
    corners = np.stack([np.stack(v, -1) for v in corners], -2)
    return {"bboxes": corners, "nms_scores": take(out[..., C - NC:], cc), "center_pred": center,
            "size_pred": size, "heading_pred": h, "size_cls": sc.astype(np.int32), "heading_cls": hc.astype(np.int32)}


# ---------------------------------------------------------------- inputs

def end_points(cfg, B, P, seed, headings=None):
    """Random head outputs (B, P, C) and proposal centres; ``headings``
    (bin, residual) pairs overwrite the first proposals' heading channels."""
    rng = np.random.RandomState(seed)
    NH, NS = cfg.num_heading_bin, cfg.num_size_cluster
    out = rng.randn(B, P, cfg.num_proposal_channels).astype(F)
    out[..., 5 + NH:5 + 2 * NH] *= 0.5  # residuals in bins, either sign
    out[..., 5 + 2 * NH + NS:5 + 2 * NH + 4 * NS] *= 0.3  # size residuals, some below -1 + 1e-6 after the x3 tail
    out[..., 5 + 2 * NH + NS:5 + 2 * NH + NS + 3] = rng.choice([-2.0, -1.0, 0.5], (B, P, 3))
    for n, (b, r) in enumerate(headings or []):
        row = out.reshape(-1, out.shape[-1])[n]
        row[5:5 + NH] = -5.0
        row[5 + b] = 5.0
        row[5 + NH + b] = r
    xyz = rng.uniform(-4, 4, (B, P, 3)).astype(F)
    return out, xyz


def heading_cases(NH):
    """(bin, residual) pairs: every bin with negative, zero and positive
    residuals, an angle of exactly 0, and angles just below, at and above
    2 pi (the wrap), by the f32 arithmetic the decode does."""
    cases = [(b, r) for b in range(NH) for r in (-0.75, -1e-7, 0.0, 0.3)]
    cases += [(0, 0.0), (0, -0.0), (0, -1e-30), (NH - 1, 1.0), (NH - 1, 0.9999999), (NH - 1, 1.0000001)]
    scale = F(heading_scale(NH))
    for b in (0, NH - 1):  # residuals whose angle rounds to f32(2 pi) and its neighbours
        target = F(dec.TWO_PI) / scale - F(2 * b)
        for r in (np.nextafter(target, F(-9)), target, np.nextafter(target, F(9))):
            cases.append((b, float(r)))
    return cases


# ------------------------------------------------------------------ tests

def test_stated_sincos_within_its_ulps_of_float64():
    """The numpy transcription on a dense grid of [0, 2 pi] and every f32
    within 20000 ulps of 0, pi/2, pi, 3 pi/2 and 2 pi: within SINCOS_ULPS
    of float64 (in units of the f32 ulp at the true value)."""
    grid = [np.linspace(0, 2 * np.pi, 1_000_001).astype(F), np.arange(20000, dtype=np.int32).view(F)]
    for m in range(1, 5):
        b = F(m * np.pi / 2).view(np.int32)
        grid.append((b + np.arange(-20000, 20001)).astype(np.int32).view(F))
    x = np.concatenate(grid)
    x = x[(x >= 0) & (x <= F(2 * np.pi))]
    s, c = np_sincos(x)
    for got, want in ((s, np.sin(x.astype(np.float64))), (c, np.cos(x.astype(np.float64)))):
        e = np.floor(np.log2(np.maximum(np.abs(want), 1e-300)))
        ulp = np.exp2(np.maximum(e, -126) - 23)
        err = np.abs(got.astype(np.float64) - want) / ulp
        assert float(err.max()) <= SINCOS_ULPS, (float(err.max()), x[err.argmax()])


def test_plain_sincos_equals_its_numpy_transcription():
    """The plain version's ops round as the transcription's, bit for bit,
    on [-4 pi, 4 pi] (both quadrant signs), the special values and NaN."""
    x = np.concatenate([np.linspace(-4 * np.pi, 4 * np.pi, 400_001).astype(F),
                        np.array([0.0, -0.0, np.pi / 4, -np.pi / 4, 2 * np.pi, np.inf, -np.inf, np.nan], F)])
    s, c = sincos_plain(torch.from_numpy(x))
    ws, wc = np_sincos(x)
    finite = np.isfinite(x)
    np.testing.assert_array_equal(bits(s)[finite], bits(ws)[finite])
    np.testing.assert_array_equal(bits(c)[finite], bits(wc)[finite])
    assert np.isnan(s.numpy()[~finite]).all() and np.isnan(c.numpy()[~finite]).all()


@pytest.mark.parametrize("config", ["tiny", "default"])
def test_plain_decode_equals_the_kernels_stated_order(config):
    """A numpy transcription of csrc/decode.cu, one f32 rounding an
    operation, equals the plain version float for float (bits), classes
    included, with tied and NaN logits among the scores."""
    cfg = tiny_config() if config == "tiny" else default_config()
    NH, NS, NC = cfg.num_heading_bin, cfg.num_size_cluster, cfg.num_class
    out, xyz = end_points(cfg, 3, 70, seed=7, headings=heading_cases(NH))
    out[0, 1, 5:5 + NH] = 1.0  # every heading bin tied: the first
    out[0, 2, 5 + 2 * NH + 1] = np.nan  # a NaN size score wins
    out[0, 3, -NC:] = 0.0
    out[0, 3, -NC + 2] = -0.0  # the maximum logit's zero sign: the first of the equal ones
    got = decode_proposals_plain({"proposals_output": torch.from_numpy(out), "proposals_xyz": torch.from_numpy(xyz)},
                                 cfg)
    want = np_decode(out, xyz, NH, NS, NC)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=k)
    assert int(want["heading_cls"][0, 1]) == 0 and int(want["size_cls"][0, 2]) == 1
    assert np.signbit(want["nms_scores"][0, 3]) == np.signbit(out[0, 3, -NC])


@pytest.mark.parametrize("config", ["tiny", "default"])
def test_plain_decode_matches_jax(config):
    """On the same end points the plain decode matches JAX's: classes
    equal, ``heading_pred`` bit-equal to ``jnp.mod``'s (fmod plus 2 pi where
    negative is its formulation), every float within REL of scale; every
    heading bin, residuals of either sign, angles of 0 and around 2 pi."""
    import jax.numpy as jnp
    from votenet_tpu.config import default_config as jax_default
    from votenet_tpu.config import tiny_config as jax_tiny
    from votenet_tpu.models.decode import decode_proposals as jax_decode

    cfg, jcfg = (tiny_config(), jax_tiny()) if config == "tiny" else (default_config(), jax_default())
    out, xyz = end_points(cfg, 2, 128, seed=3, headings=heading_cases(cfg.num_heading_bin))
    got = decode_proposals_plain({"proposals_output": torch.from_numpy(out), "proposals_xyz": torch.from_numpy(xyz)},
                                 cfg)
    want = jax_decode({"proposals_output": jnp.asarray(out), "proposals_xyz": jnp.asarray(xyz)}, jcfg)
    assert sorted(got) == sorted(want)
    for k in ("size_cls", "heading_cls"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(bits(got["heading_pred"]), bits(want["heading_pred"]))
    assert float(got["heading_pred"].max()) <= dec.TWO_PI and float(got["heading_pred"].min()) >= 0.0
    for k in ("bboxes", "class_scores", "objectness", "nms_scores", "center_pred", "size_pred"):
        close(got[k], want[k])


def test_heading_reduction_is_jnp_mod_bit_for_bit():
    """fmod(x, f32(2 pi)) plus f32(2 pi) where negative, on angles of
    either sign up to 3 turns, the zeros and the multiples of 2 pi: the bits
    of ``jnp.mod(x, 2 * np.pi)``."""
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    two_pi = F(dec.TWO_PI)
    x = np.concatenate([rng.uniform(-20, 20, 200_000).astype(F), np.array([0.0, -0.0, two_pi, -two_pi, 3 * two_pi], F),
                        np.nextafter(two_pi, F(0)) * np.array([1, -1], F), np.array([-1e-30, 1e-30, -1e-7], F)])
    t = torch.from_numpy(x)
    got = torch.fmod(t, dec.TWO_PI)
    got = torch.where(got < 0, got + dec.TWO_PI, got)
    np.testing.assert_array_equal(bits(got), bits(jnp.mod(jnp.asarray(x), 2 * np.pi)))


def test_decode_routes_and_refuses_cpu_tensors_on_the_kernel():
    """A CPU tensor takes the plain version (no launch); the kernel's
    wrapper, given CPU tensors, raises before it builds anything; outputs
    keep their keys, dtypes and shapes, and ``class_scores`` and
    ``objectness`` are views of the head's output."""
    cfg = tiny_config()
    out, xyz = end_points(cfg, 2, 16, seed=1)
    ep = {"proposals_output": torch.from_numpy(out), "proposals_xyz": torch.from_numpy(xyz)}
    before = decode_proposals_cuda.launches
    got = decode_proposals(ep, cfg)
    assert decode_proposals_cuda.launches == before == 0
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in got.items()}
    f, i = torch.float32, torch.int32
    assert shapes == {"bboxes": ((2, 16, 8, 3), f), "class_scores": ((2, 16, cfg.num_class), f),
                      "objectness": ((2, 16, 2), f), "nms_scores": ((2, 16), f), "center_pred": ((2, 16, 3), f),
                      "size_pred": ((2, 16, 3), f), "heading_pred": ((2, 16), f), "size_cls": ((2, 16), i),
                      "heading_cls": ((2, 16), i)}
    base = ep["proposals_output"].untyped_storage().data_ptr()
    assert got["objectness"].untyped_storage().data_ptr() == base == got["class_scores"].untyped_storage().data_ptr()
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        decode_proposals_cuda(ep["proposals_output"], ep["proposals_xyz"], torch.from_numpy(CLASS_MEAN_SIZE), 12, 10,
                              10)


def test_get_3d_bbox_matches_jax():
    """The corner-izer alone (the stated rotation) against JAX's einsum form
    on boxes of any heading, sizes and centres."""
    import jax.numpy as jnp
    from votenet_tpu.models.decode import get_3d_bbox as jax_bbox

    rng = np.random.RandomState(5)
    size = rng.uniform(0.1, 3, (4, 50, 3)).astype(F)
    heading = rng.uniform(-2 * np.pi, 4 * np.pi, (4, 50)).astype(F)
    center = rng.uniform(-5, 5, (4, 50, 3)).astype(F)
    got = dec.get_3d_bbox(torch.from_numpy(size), torch.from_numpy(heading), torch.from_numpy(center))
    close(got, jax_bbox(jnp.asarray(size), jnp.asarray(heading), jnp.asarray(center)))


@pytest.mark.parametrize("max_detections", [256, 5])
def test_predict_boxes_matches_jax(max_detections):
    """``predict_boxes`` at full width (256 proposals, default channels) on
    the same random end points as JAX's: the keep mask and the classes
    equal, the floats within REL; with a cap below the proposal count the
    cap's argsort runs too."""
    import jax.numpy as jnp
    from votenet_tpu.config import default_config as jax_default
    from votenet_tpu.models.decode import predict_boxes as jax_predict

    cfg, jcfg = default_config(max_detections=max_detections), jax_default(max_detections=max_detections)
    out, xyz = end_points(cfg, 2, 256, seed=11)
    xyz *= 0.6  # a smaller room: overlaps for NMS to suppress
    out[..., 1] += 0.3  # about half the proposals candidates
    got = predict_boxes({"proposals_output": torch.from_numpy(out), "proposals_xyz": torch.from_numpy(xyz)}, cfg)
    want = jax_predict({"proposals_output": jnp.asarray(out), "proposals_xyz": jnp.asarray(xyz)}, jcfg)
    for k in ("size_cls", "heading_cls", "keep"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("bboxes", "nms_scores", "center_pred", "size_pred", "heading_pred"):
        close(got[k], want[k])
    cand = out[..., 1] > out[..., 0]
    kept = got["keep"].numpy()
    assert kept.sum() > 0 and (max_detections < 256 or kept.sum() < cand.sum())
    assert (kept.sum(-1) <= max_detections).all()
    assert math.isclose(heading_scale(12), float(F(np.pi / 12)))


@pytest.mark.parametrize("config,B,P", [("tiny", 1, 37), ("default", 2, 256), ("default", 1, 1)])
def test_decode_with_iou_plain_route_is_the_decode_and_the_plain_iou(config, B, P):
    """On a CPU tensor the fused op is ``decode_proposals_plain`` and the
    IoU's plain version on its corners, bit for bit (the kernel is held to
    the same in ``tests/test_torch_cuda.py``), with no launch; the kernel's
    wrapper refuses CPU tensors."""
    cfg = tiny_config() if config == "tiny" else default_config()
    out, xyz = end_points(cfg, B, P, seed=P, headings=heading_cases(cfg.num_heading_bin)[:P])
    ep = {"proposals_output": torch.from_numpy(out), "proposals_xyz": torch.from_numpy(xyz)}
    before = decode_iou_cuda.launches
    got, iou = decode_with_iou(ep, cfg)
    want = decode_proposals_plain(ep, cfg)
    want_iou = box3d_iou_matrix_plain(want["bboxes"], want["bboxes"])
    assert decode_iou_cuda.launches == before == 0 and sorted(got) == sorted(want)
    for k in want:  # f32 and int32 fields: their 4-byte words
        g, w = (np.ascontiguousarray(v.numpy()).view(np.int32) for v in (got[k], want[k]))
        assert got[k].dtype == want[k].dtype and np.array_equal(g, w), k
    assert iou.shape == (B, P, P) and np.array_equal(bits(iou), bits(want_iou))
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        decode_iou_cuda(ep["proposals_output"], ep["proposals_xyz"], torch.from_numpy(CLASS_MEAN_SIZE),
                        cfg.num_heading_bin, cfg.num_size_cluster, cfg.num_class)


def test_decode_with_iou_matches_jax():
    """The fused op against JAX's ``decode_proposals`` and
    ``box3d_iou_matrix`` of its corners on the same end points: every
    decoded float within REL of scale (``test_plain_decode_matches_jax``'s),
    the classes equal, the IoU within REL on the pairs of distinct boxes
    (JAX's CPU IoU of a box with itself is no reference: XLA's FMAs,
    ``tests/test_torch_iou.py``), and on the diagonal exactly 1 for a box of
    volume (0 or 1 for the boxes the 1e-6 size floor flattens, whose union
    is within a rounding of the IoU's 1e-12)."""
    import jax.numpy as jnp
    from votenet_tpu.config import default_config as jax_default
    from votenet_tpu.models.decode import decode_proposals as jax_decode
    from votenet_tpu.ops.iou3d import box3d_iou_matrix as jax_iou

    cfg = default_config()
    out, xyz = end_points(cfg, 2, 256, seed=13)
    xyz *= 0.6  # a smaller room: overlapping boxes
    got, iou = decode_with_iou({"proposals_output": torch.from_numpy(out), "proposals_xyz": torch.from_numpy(xyz)},
                               cfg)
    want = jax_decode({"proposals_output": jnp.asarray(out), "proposals_xyz": jnp.asarray(xyz)}, jax_default())
    for k in ("size_cls", "heading_cls"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("bboxes", "nms_scores", "center_pred", "size_pred", "heading_pred"):
        close(got[k], want[k])
    want_iou = np.asarray(jax_iou(want["bboxes"], want["bboxes"]))
    off = ~np.eye(256, dtype=bool)[None].repeat(2, 0)
    iou = iou.numpy()
    assert int((iou[off] > 0).sum()) > 2 * 256  # overlapping pairs off the diagonal
    np.testing.assert_allclose(iou[off], want_iou[off], rtol=0, atol=REL)
    diag = np.diagonal(iou, axis1=1, axis2=2)
    solid = got["size_pred"].double().prod(-1).numpy() > 1e-6
    assert (diag[solid] == 1.0).all() and ((diag == 0.0) | (diag == 1.0)).all() and solid.sum() > 256
