"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the ``cuda`` fixture, never at import). Run on a
machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from votenet_tpu.config import tiny_config
from votenet_tpu.data.synthetic import synthetic_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def cloud(seed, B, N, kind):
    rng = np.random.RandomState(seed)
    if kind == "scene":
        cfg = tiny_config(point_num=N)
        return np.stack([synthetic_scene(rng, cfg)["points"] for _ in range(B)])
    if kind == "grid":  # exact integer distances: ties everywhere
        g = np.stack(np.meshgrid(np.arange(16), np.arange(16), np.arange(8), indexing="ij"), -1).reshape(-1, 3)
        return np.stack([g[rng.permutation(len(g))][:N] for _ in range(B)]).astype(np.float32)
    return rng.randn(B, N, 3).astype(np.float32)


@pytest.mark.parametrize(
    "B,N,npoint,kind",
    [(1, 20480, 2048, "scene"), (8, 2048, 1024, "scene"), (3, 1111, 97, "normal"),
     (2, 2048, 300, "grid"), (1, 64, 1, "normal"), (2, 70000, 128, "normal")],
)
def test_fps_kernel_matches_plain(cuda, B, N, npoint, kind):
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda, farthest_point_sample_plain

    xyz = torch.from_numpy(cloud(B + N, B, N, kind)).to(cuda)  # N=70000 takes the global-scratch path
    got = farthest_point_sample_cuda(npoint, xyz)
    torch.cuda.synchronize()
    assert torch.equal(got, farthest_point_sample_plain(npoint, xyz))


@pytest.mark.parametrize(
    "B,N,M,radius,S,kind",
    [(1, 20480, 2048, 0.2, 64, "scene"), (8, 2048, 1024, 0.4, 64, "scene"), (2, 1024, 256, 0.3, 64, "normal"),
     (2, 300, 50, 1.5, 16, "grid"), (1, 100, 7, 0.01, 8, "normal")],
)
def test_ball_query_kernel_matches_plain(cuda, B, N, M, radius, S, kind):
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda, query_ball_point_plain

    xyz = torch.from_numpy(cloud(B * N, B, N, kind)).to(cuda)
    q = xyz[:, :M].clone()
    q[0, -1] = 1000.0  # empty ball
    got = query_ball_point_cuda(radius, S, xyz, q)
    torch.cuda.synchronize()
    want = query_ball_point_plain(radius, S, xyz, q)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1][0, -1]) == 0


def test_ball_query_kernel_r2_boundary(cuda):
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda

    p = torch.tensor([[[0.19999999, 5e-05, 0.0], [1.0, 1.0, 1.0]]], device=cuda)
    idx, cnt = query_ball_point_cuda(0.2, 4, p, torch.zeros((1, 1, 3), device=cuda))
    assert int(cnt[0, 0]) == 1 and idx[0, 0].tolist() == [0, 0, 0, 0]


def test_predictor_on_the_card_matches_cpu(cuda):
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda
    from votenet_tpu_torch.predictor import VoteNetPredictor

    cfg = tiny_config()
    points = np.stack([synthetic_scene(np.random.RandomState(i), cfg)["points"] for i in range(2)])
    gpu = VoteNetPredictor(cfg, device=cuda, batch_size=2)
    cpu = VoteNetPredictor(cfg, {k: v.cpu() for k, v in gpu.model.state_dict().items()}, device="cpu")
    before = (farthest_point_sample_cuda.launches, query_ball_point_cuda.launches)
    g = gpu(points)
    after = (farthest_point_sample_cuda.launches, query_ball_point_cuda.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (5, 5)
    c = cpu(points)
    torch.testing.assert_close(g["bboxes"].cpu(), c["bboxes"], rtol=0, atol=1e-4)
    assert torch.equal(g["keep"].cpu(), c["keep"])


# live shapes of the full-width training step's scatters: (K = M*S, N, C)
SCATTER_SHAPES = {
    "sa2": (1024 * 64, 2048, 128),
    "sa3": (512 * 64, 1024, 256),
    "sa4": (256 * 64, 512, 256),
    "proposal": (256 * 64, 1024, 259),
}


def scatter_inputs(seed, B, K, N, C, device):
    rng = np.random.RandomState(seed)
    g = rng.randn(B, K, C).astype(np.float32)
    idx = rng.randint(0, N, size=(B, K)).astype(np.int32)
    return torch.from_numpy(g).to(device), torch.from_numpy(idx).to(device)


@pytest.mark.parametrize("B", [2, 8])
@pytest.mark.parametrize("layer", list(SCATTER_SHAPES))
def test_scatter_kernel_matches_plain(cuda, layer, B):
    """Bit-equal to the plain version run on the CPU (index_add_ adds in
    index order there); within 1e-5 of scale of the plain version on the
    card, whose atomics add in another order."""
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda, scatter_add_plain

    K, N, C = SCATTER_SHAPES[layer]
    g, idx = scatter_inputs(B + C, B, K, N, C, cuda)
    got = scatter_add_cuda(g, idx, N)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), scatter_add_plain(g.cpu(), idx.cpu(), N))
    torch.testing.assert_close(got, scatter_add_plain(g, idx, N), rtol=0, atol=1e-5 * float(got.abs().max()))


def test_scatter_kernel_is_deterministic(cuda):
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda

    K, N, C = SCATTER_SHAPES["sa2"]
    g, idx = scatter_inputs(0, 8, K, N, C, cuda)
    a = scatter_add_cuda(g, idx, N)
    b = scatter_add_cuda(g, idx, N)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize(
    "B,K,N,C,skip",
    [(1, 256 * 64, 512, 259, 3), (2, 777, 100, 131, 3), (3, 5, 70, 1, 0), (1, 1000, 65536 * 2, 16, 0),
     (1, 3000, 40, 1100, 0)],
    ids=["sa4-B1", "ragged", "tiny", "tiles-past-one-wave", "channel-split"],
)
def test_scatter_kernel_equals_add_at(cuda, B, K, N, C, skip):
    """Bit-equal to a sequential np.add.at, through ops.scatter_add as the
    group_point backward calls it (the live columns after ``skip``): K not a
    multiple of 32, N not a multiple of the 64-row tile, more tiles than one
    wave of blocks, C split over two blocks."""
    from votenet_tpu_torch.ops import scatter_add

    g, idx = scatter_inputs(K + N, B, K, N, C, cuda)
    got = scatter_add(g[..., skip:], idx, N)
    torch.cuda.synchronize()
    gn, inp = g[..., skip:].cpu().numpy(), idx.cpu().numpy()
    want = np.zeros((B, N, C - skip), np.float32)
    for b in range(B):
        np.add.at(want[b], inp[b], gn[b])
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_train_step_on_the_card_matches_cpu(cuda):
    """One tiny training step on the card and on the CPU from the same
    weights: each layer's scatter launched once (sa2-sa4 and the proposal
    layer), losses and updated weights close."""
    from votenet_tpu.data.dataflow import batch_scenes
    from votenet_tpu.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda
    from votenet_tpu_torch.train import create_train_state, make_train_step

    cfg = tiny_config()
    batch = next(batch_scenes(iter(synthetic_scenes(0, cfg, 2)), 2, cfg.max_gt_boxes))
    gpu = create_train_state(cfg, 10, device=cuda)
    cpu = create_train_state(cfg, 10)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    step = make_train_step(cfg)
    before = scatter_add_cuda.launches
    mg = step(gpu, batch)
    assert scatter_add_cuda.launches - before == 4
    mc = step(cpu, batch)
    for k in mg:
        assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * max(1.0, abs(float(mc[k]))), k
    for (name, a), b in zip(gpu.model.state_dict().items(), cpu.model.state_dict().values()):
        assert float((a.cpu() - b).abs().max()) <= 2 * cfg.base_lr + 1e-4, name
    assert gpu.step == cpu.step == 1
