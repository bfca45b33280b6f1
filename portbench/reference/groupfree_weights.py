"""Group-Free 3D's weights drawn from the seed on the device, for the
program and the reference alike, by ``weights.seeded_weights``'s
convention: every 2-d kernel (the attention's in-projections among them)
he-normal (a normal cut at two standard deviations, variance 2 / fan_in),
drawn in one call in :func:`groupfree_ref.param_names`' order from a
generator seeded with the seed; biases 0; batch-norm and LayerNorm scales
1; running statistics 0 and 1."""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.groupfree_ref import param_names


def seeded_weights(seed: int, cfg: dict, device) -> Dict[str, torch.Tensor]:
    params, buffers = param_names(cfg)
    kernels = [(n, s) for n, s in params if len(s) == 2]
    total = sum(math.prod(s) for _, s in kernels)
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.clamp(torch.randn(total, generator=g, device=device), -2.0, 2.0)
    out: Dict[str, torch.Tensor] = {}
    pos = 0
    for n, (cout, cin) in kernels:
        out[n] = (z[pos:pos + cout * cin].view(cout, cin) * (math.sqrt(2.0 / cin) / 0.8796256610342398)).clone()
        pos += cout * cin
    for n, s in params:
        if n not in out:  # biases (in_proj_bias too) 0; batch-norm and LayerNorm scales 1
            out[n] = torch.zeros(s, device=device) if n.endswith("bias") else torch.ones(s, device=device)
    for n, s in buffers:
        out[n] = torch.zeros(s, device=device) if n.endswith("running_mean") else torch.ones(s, device=device)
    return out


def head_names(cfg: dict):
    """The state-dict prefix of each prediction head's MLP, first head first."""
    return ["proposal_head"] + [f"prediction_heads.{i}" for i in range(cfg["num_layers"])]


def calibrate_objectness(params: Dict[str, torch.Tensor], cfg: dict, points: torch.Tensor, share: float) -> None:
    """Set each head's objectness bias (channel 0 of its last dense layer)
    so that ``share`` of the proposals of ``points`` score above 0, the
    candidate test: the bias becomes minus the (1 - share) quantile of that
    head's objectness over the scenes' proposals, from one plain forward
    (a head's objectness feeds no later layer, so one forward gives every
    head's)."""
    from portbench.reference.groupfree_ref import eval_forward

    ep = eval_forward(params, points, cfg)
    prefixes = ["proposal_"] + [f"{i}head_" for i in range(cfg["num_layers"] - 1)] + ["last_"]
    for name, prefix in zip(head_names(cfg), prefixes):
        x = ep[prefix + "head"][..., 0].flatten().double()
        params[f"{name}.dense2.bias"][0] = params[f"{name}.dense2.bias"][0] - torch.quantile(x, 1.0 - share).float()
