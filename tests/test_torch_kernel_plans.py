"""The launch plans of the ball-query and samlp kernels, and the 3xTF32
arithmetic of the samlp kernel, on the CPU.

The plans are pure functions of the shapes (``ops/cuda/ballquery.py``
``ballquery_route``, ``ops/cuda/samlp.py`` ``samlp_plan``): every shape of
``default_config()`` and ``tiny_config()`` must get a launch the kernels
take, within a block's 227 KB of shared memory. The 3xTF32 split is
emulated in plain PyTorch (``tf32_split``, ``chain_3xtf32``: TF32 rounding
as ``cvt.rna.tf32.f32`` does it, the low 13 mantissa bits rounded off to
nearest, ties away from zero) and held within the samlp tolerance (1e-5 of
the output's scale) of the f32 plain version and of the JAX package's Pallas
kernel in interpret mode; one TF32 product per f32 product (1xTF32) lands
outside it on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cuda import chain_inputs
from votenet_tpu_torch.config import default_config, tiny_config
from votenet_tpu_torch.ops.cuda import ballquery as bq_mod
from votenet_tpu_torch.ops.cuda import samlp as samlp_mod

SAMLP_TOL = 1e-5  # of the output's scale, as chip_smoke.py and tests/test_torch_cuda.py
H100_SMS = 132


def sa_shapes(cfg):
    """(layer, N, M, radius, nsample, samlp widths) of every SA layer of a
    forward: sa1-sa4 over the chained clouds, the proposal layer over the
    seeds (sa2's centres)."""
    clouds = (cfg.point_num,) + tuple(cfg.sa_npoints)
    out = [(f"sa{i + 1}", clouds[i], clouds[i + 1], cfg.sa_radii[i], cfg.sa_nsamples[i], list(cfg.sa_mlps[i]))
           for i in range(4)]
    out.append(("proposal", cfg.sa_npoints[1], cfg.proposal_num, cfg.proposal_radius, cfg.proposal_nsample,
                list(cfg.proposal_mlp)))
    return out


CONFIGS = {"default": default_config(), "tiny": tiny_config()}


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_ballquery_route_covers_every_shape(cfg_name, B):
    """Segments are whole tiles, cover N exactly once, stay within the
    rule's cap, and split only a grid short of the rule's blocks."""
    for layer, N, M, _, S, _ in sa_shapes(CONFIGS[cfg_name]):
        nseg, seg_pts = bq_mod.ballquery_route(B, N, M, H100_SMS)
        assert 1 <= nseg <= bq_mod.BQ_MAX_SEGMENTS, layer
        assert seg_pts % bq_mod.BQ_TILE == 0, layer
        assert (nseg - 1) * seg_pts < N <= nseg * seg_pts, layer
        blocks = B * -(-M // bq_mod.BQ_QUERIES) * nseg
        if nseg > 1:  # split only while the grid is short of the rule's blocks
            assert B * -(-M // bq_mod.BQ_QUERIES) < H100_SMS * bq_mod.BQ_BLOCKS_PER_SM, layer
        assert blocks <= B * -(-M // bq_mod.BQ_QUERIES) * bq_mod.BQ_MAX_SEGMENTS


def test_ballquery_route_takes_both_routes():
    """The default configuration's shapes split (few queries for the card);
    the tiny configuration's clouds are below two tiles and do not; sa1's
    routes are pinned at B=1 and B=8."""
    routes = {cfg: {bq_mod.ballquery_route(B, N, M, H100_SMS)[0] > 1
                    for B in (1, 8) for _, N, M, _, _, _ in sa_shapes(c)} for cfg, c in CONFIGS.items()}
    assert routes == {"default": {True}, "tiny": {False}}
    assert bq_mod.ballquery_route(1, 20480, 2048, H100_SMS) == (16, 1280)
    assert bq_mod.ballquery_route(8, 20480, 2048, H100_SMS) == (16, 1280)
    assert bq_mod.ballquery_route(8, 512, 256, H100_SMS) == (2, 256)


@pytest.mark.parametrize("segments,want", [(1, (1, 20480)), (3, (3, 6912)), (7, (7, 3072)), (80, (80, 256)),
                                           (1000, (80, 256))])
def test_ballquery_route_forced(segments, want):
    """A forced count is rounded to whole tiles (never more than N / tile)."""
    assert bq_mod.ballquery_route(8, 20480, 2048, H100_SMS, segments) == want


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_samlp_plan_fits_every_shape(cfg_name):
    """Each SA layer's chain gets a plan within a block's shared memory, with
    at least two ring stages, wgmma N at least the width, K chained from the
    previous layer's N, and the tile holding whole centres."""
    for layer, _, _, _, S, widths in sa_shapes(CONFIGS[cfg_name]):
        plan = samlp_mod.samlp_plan(S, widths)
        assert plan.smem <= samlp_mod.SMEM_LIMIT and 2 <= plan.stages <= samlp_mod.MAX_STAGES, layer
        assert plan.ks in (16, 32) and all(k % 32 == 0 for k in plan.kpad), layer
        assert all(n in samlp_mod.N_PADS and n >= w for n, w in zip(plan.npad, widths[1:])), layer
        assert plan.kpad[0] >= widths[0] and list(plan.kpad[1:]) == list(plan.npad[:-1]), layer
        assert plan.T * S <= samlp_mod.ROWS and plan.R == 1, layer
        assert plan.wsplit == sum(2 * k * n for k, n in zip(plan.kpad, plan.npad))


@pytest.mark.parametrize("S,widths,T,R,ks", [(24, [32, 32, 64], 2, 1, 32), (100, [128, 256, 64], 1, 2, 16),
                                             (5, [8, 24, 16], 12, 1, 32), (8, [5, 7, 13, 3], 8, 1, 32)])
def test_samlp_plan_odd_shapes(S, widths, T, R, ks):
    """S that does not divide 64 (masked rows), S above a tile (R tiles a
    centre), narrow slices where two wide stages would not fit, widths not a
    multiple of 8."""
    plan = samlp_mod.samlp_plan(S, widths)
    assert (plan.T, plan.R, plan.ks) == (T, R, ks)
    assert plan.smem <= samlp_mod.SMEM_LIMIT and plan.stages >= 2


@pytest.mark.parametrize("widths", [[300, 64, 64], [64, 257], [0, 16]])
def test_samlp_plan_refuses_widths_it_cannot_lay_out(widths):
    with pytest.raises(ValueError):
        samlp_mod.samlp_plan(64, widths)


def bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def test_tf32_split_rounds_as_cvt_rna():
    """Ties go away from zero, above and below a tie to the nearer; big and
    small keep 10 mantissa bits; big + small is x to ~2^-22."""
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, one + 2.0 ** -11 - 2.0 ** -23, -(one + 2.0 ** -11),
                      one + 3 * 2.0 ** -11, 3.0], dtype=torch.float32)
    big, small = samlp_mod.tf32_split(x)
    want = torch.tensor([one + 2.0 ** -10, one, -(one + 2.0 ** -10), one + 2.0 ** -9, 3.0])
    assert torch.equal(big, want)
    rng = np.random.RandomState(0)
    r = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.uniform(-3, 3, 4096)).astype(np.float32))
    big, small = samlp_mod.tf32_split(r)
    assert not (bits(big) & 0x1FFF).any() and not (bits(small) & 0x1FFF).any()
    rel = ((big.double() + small.double() - r.double()).abs() / r.double().abs()).max()
    assert float(rel) <= 2.0 ** -21
    assert float(((big.double() - r.double()).abs() / r.double().abs()).max()) <= 2.0 ** -11


SHAPES = [(2, 48, 16, [16, 16, 32]), (1, 40, 64, [64, 64, 128]), (2, 30, 8, [32, 32, 64]),
          (1, 20, 24, [13, 21, 37, 9])]


@pytest.mark.parametrize("B,M,S,widths", SHAPES, ids=["tiny", "sa1-widths", "tiny-sa2", "odd-widths-S24"])
def test_3xtf32_within_tolerance_of_f32_and_jax(B, M, S, widths):
    """The kernel's arithmetic, emulated: within 1e-5 of scale of the f32
    plain version and of the JAX Pallas kernel (interpret mode); 1xTF32 on
    the same inputs, with full 24-bit mantissas at these magnitudes, is not."""
    from votenet_tpu.ops.pallas.samlp import fused_sa_mlp_pool

    N = 3 * M
    h_all, idx, sh0, s0, layers = chain_inputs(B * M + S, B, N, M, S, widths)
    h_all = (h_all * 37.0).astype(np.float32)
    args = [torch.from_numpy(a) for a in (h_all, idx, sh0, s0)] + [
        [tuple(torch.from_numpy(x) for x in lay) for lay in layers]]
    plain = samlp_mod.fused_sa_mlp_pool_plain(*args)
    h0 = h_all[np.arange(B)[:, None, None], idx]
    jax_out = np.asarray(fused_sa_mlp_pool(jnp.asarray(h0), jnp.asarray(sh0), jnp.asarray(s0),
                                           [tuple(jnp.asarray(a) for a in lay) for lay in layers], interpret=True))
    three = samlp_mod.chain_3xtf32(*args)
    one = samlp_mod.chain_3xtf32(*args, terms=1)
    tol = SAMLP_TOL * float(plain.abs().max())
    assert float((three - plain).abs().max()) <= tol
    assert float(np.abs(three.numpy() - jax_out).max()) <= tol
    assert float((one - plain).abs().max()) > tol


def bf16_smem(plan, held):
    """The bf16 kernel's shared memory (csrc/samlp.cu ``bf16_smem``) beside
    ``held`` bytes of weights (the chain or the ring): its slots' staged
    tiles (64 rows of h_all and T + 1 of sh0, K0 + 8 floats a row), pooled
    rows, the affine vectors and the last layer's scale's signs, five steps'
    index rows (two tiles each), 25 mbarriers."""
    tile = (64 + plan.T + 1) * (plan.kpad[0] + 8) * 4
    return (held + plan.slots * tile + 2 * plan.T * plan.npad[-1] * 4
            + (plan.kpad[0] + 2 * sum(plan.npad) + plan.npad[-1]) * 4 + 10 * 64 * 4 + 25 * 8)


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_samlp_plan_bf16_fits_every_shape(cfg_name):
    """The bf16 kernel's plan at every SA layer: the chain resident in shared
    memory beside the staged tiles (one 2-byte term a weight, the scratch a
    quarter of 3xTF32's and a row of zeros), slices of 64 channels where every layer's K takes
    them (four k16 steps), with the f32 plan's tile, N and K; forced onto
    the ring, two to four stages of the same slices."""
    for layer, _, _, _, S, widths in sa_shapes(CONFIGS[cfg_name]):
        plan = samlp_mod.samlp_plan(S, widths, "bf16")
        f32 = samlp_mod.samlp_plan(S, widths)
        assert (plan.T, plan.R, plan.npad, plan.kpad) == (f32.T, f32.R, f32.npad, f32.kpad), layer
        assert plan.route == "resident" and plan.stages == 0 and f32.route == "ring", layer
        assert plan.ks == (64 if all(k % 64 == 0 for k in plan.kpad) else 32), layer
        assert all(k % plan.ks == 0 for k in plan.kpad), layer
        assert plan.wsplit * 4 - 1024 == sum(2 * k * n for k, n in zip(plan.kpad, plan.npad)) == f32.wsplit  # a zero row
        assert plan.smem == bf16_smem(plan, plan.wsplit * 4 - 1024) <= samlp_mod.SMEM_LIMIT, layer
        assert 2 <= plan.slots <= samlp_mod.MAX_SLOTS, layer
        ring = samlp_mod.samlp_plan(S, widths, "bf16", "ring")
        assert ring.route == "ring" and 2 <= ring.stages <= samlp_mod.MAX_STAGES and ring.ks == plan.ks, layer
        stage = min(max(plan.npad), 128) * plan.ks * 2  # a chunk of at most 128 columns of a slice
        assert ring.smem == bf16_smem(ring, ring.stages * stage) <= samlp_mod.SMEM_LIMIT, layer
        assert 2 <= ring.slots <= samlp_mod.MAX_SLOTS and ring[:4] == plan[:4] and ring.wsplit == plan.wsplit, layer


@pytest.mark.parametrize("S,widths,route,ks,stages,ring_stages,slots",
                         [(64, [64, 64, 128], "resident", 64, 0, 4, 8), (64, [128, 128, 256], "resident", 64, 0, 4, 3),
                          (8, [16, 16, 32], "resident", 32, 0, 4, 8), (7, [6, 9, 13], "resident", 32, 0, 4, 8),
                          (100, [128, 256, 64], "resident", 64, 0, 4, 3), (24, [40, 32, 64], "resident", 32, 0, 4, 8),
                          (64, [128, 256, 256, 128], "ring", 64, 4, 4, 4), (64, [256] * 4, "ring", 64, 4, 4, 2),
                          (64, [200, 256, 128], "ring", 64, 4, 4, 2), (64, [200, 64, 128], "resident", 64, 0, 4, 2),
                          (2, [128, 128, 256], "ring", 64, 3, 3, 2), (1, [64, 64, 128], "resident", 64, 0, 4, 3),
                          (100, [96, 256, 256, 64], "ring", 64, 4, 4, 4)])
def test_samlp_plan_bf16_slices(S, widths, route, ks, stages, ring_stages, slots):
    """sa2-sa4's chain (96 KB) and every chain of the five live shapes' sizes
    stay resident in 64-channel slices where every K takes them, else 32; a
    chain too wide for the shared memory beside its tiles streams through
    the ring, a chunk of at most 128 columns of a slice a stage, four stages
    where they fit (the 3xTF32 kernel holds two 32-channel slices of all 256
    columns at sa2), three where 32 centres' sh0 rows and pooled rows a
    tile (S = 2) take the room; w0 of 200 or 96 takes a K0 of 256 or 128.
    The staged tiles take what is left, 2 to 8 slots (sa1: 8, sa2-sa4: 3)."""
    plan = samlp_mod.samlp_plan(S, widths, "bf16")
    assert (plan.route, plan.ks, plan.stages, plan.slots) == (route, ks, stages, slots)
    assert plan.kpad[0] == next(k for k in (32, 64, 128, 256) if k >= widths[0])
    assert plan.smem <= samlp_mod.SMEM_LIMIT
    assert samlp_mod.samlp_plan(S, widths, "bf16", "ring").stages == ring_stages


def test_samlp_plan_bf16_takes_the_ring_where_the_chain_is_too_wide():
    """Three 256 x 256 layers (384 KB of bf16) never fit: the default plan
    and a forced ring stream them, a forced resident chain raises."""
    widths = [256, 256, 256, 256]
    assert samlp_mod.samlp_plan(64, widths, "bf16").route == "ring"
    assert samlp_mod.samlp_plan(64, widths, "bf16", "ring").stages >= 2
    with pytest.raises(ValueError, match="resident"):
        samlp_mod.samlp_plan(64, widths, "bf16", "resident")


@pytest.mark.parametrize("S,widths", [(1, [256, 256, 256]), (2, [256, 256, 256]), (1, [256, 32, 256])])
def test_samlp_plan_bf16_refuses_what_fits_neither_route(S, widths):
    """One or two slots a tile (64 or 32 centres, their sh0 rows staged and
    pooled) at K0 = 256: the staged tiles alone leave no room for two ring
    stages."""
    with pytest.raises(ValueError, match="shared memory"):
        samlp_mod.samlp_plan(S, widths, "bf16")


@pytest.mark.parametrize("precision,route", [("f32", "resident"), ("bf16", "tiled"), ("f32", "ring-fast")])
def test_samlp_plan_refuses_other_routes(precision, route):
    with pytest.raises(ValueError, match="route"):
        samlp_mod.samlp_plan(64, [64, 64, 128], precision, route)


def test_samlp_plan_refuses_other_precisions():
    with pytest.raises(ValueError, match="precision"):
        samlp_mod.samlp_plan(64, [64, 64, 128], "tf32")


def test_samlp_ablation_variants_apply_to_the_source():
    """chip_smoke.py --samlp-ablation edits csrc/samlp.cu by exact
    replacement: each variant's old texts stand in the source once, in
    turn, so an edit of the kernel that moves them fails here first."""
    import chip_smoke
    from votenet_tpu_torch.ops.cuda import CSRC_DIR

    src = (CSRC_DIR / "samlp.cu").read_text()
    for name, (_, changes) in chip_smoke.samlp_ablation_edits().items():
        text = src
        for old, new in changes:
            assert text.count(old) == 1, (name, old[:60])
            text = text.replace(old, new)
        assert text != src, name
