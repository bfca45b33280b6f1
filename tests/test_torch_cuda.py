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
