"""How far B9's bf16 path moves its output by rounding P to bf16, before
the output's own rounding, on the card tests' edge cases (CPU).

The tensor-core kernel (``csrc/flash_attention.cu``) computes the
scores from bf16 q and k with float32 accumulation, keeps the online
softmax in float32 per 64-key tile, and rounds P to bf16 for the PV
product.  This script repeats that tile arithmetic in PyTorch on the
CPU, once with P rounded and once with P kept in float32, on the inputs
of ``tests/test_torch_gpu.py::test_cuda_flash_attention_bf16_tensor_cores_edges``,
and prints the largest distance of each from the plain float32 result,
in bf16 ulps at the plain output's largest magnitude.  Below one ulp,
the kernel's and the plain version's bf16 outputs can differ by one
rounding flip (what the 8e-3 gate admits at the top binade), not two.

    PYTHONPATH=src python scripts/fa_bf16_rounding.py
"""
from __future__ import annotations

import itertools
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
LOG2E = 1.4426950408889634


def plain_f32(q, k, v, causal, cap):
    """The plain version (``kernels/flash_attention/ref.py``) before its
    output is rounded to bf16."""
    s = q.shape[2]
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, 1).float()
    v = v.repeat_interleave(g, 1).float()
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / q.shape[3] ** 0.5
    if cap:
        sc = cap * torch.tanh(sc / cap)
    if causal:
        sc = torch.where(torch.ones((s, s), dtype=torch.bool).tril(), sc,
                         -1e30)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    return torch.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdim=True), v)


def kernel_tiles(q, k, v, causal, cap, round_p):
    """The kernel's arithmetic: scores into the log2 domain by one
    multiply (or around the cap's tanh), 64-key tiles, the running max
    and sum in float32, P rounded to bf16 for the PV product if
    ``round_p``."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, 1).float()
    v = v.repeat_interleave(g, 1).float()
    x = torch.einsum("bhqd,bhkd->bhqk", q.float(), k)
    if cap:
        x = (cap * LOG2E) * torch.tanh(x * (1.0 / math.sqrt(d) / cap))
    else:
        x = x * (LOG2E / math.sqrt(d))
    if causal:
        x = torch.where(torch.ones((s, s), dtype=torch.bool).tril(), x,
                        torch.tensor(-1e30))
    m = torch.full((b, hq, s, 1), -1e30)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    for k0 in range(0, s, 64):
        xt = x[..., k0:k0 + 64]
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(xt - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = p.bfloat16().float() if round_p else p
        acc = acc * corr + pv @ v[..., k0:k0 + 64, :]
        m = m_new
    return acc / l


def main() -> int:
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import _attention_case
    worst = {True: (0.0, None), False: (0.0, None)}
    for s, d, group, causal, cap in itertools.product(
            (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000), (64, 128),
            (1, 3, 8), (True, False), (0.0, 30.0)):
        q, k, v = (torch.from_numpy(a).bfloat16() for a in _attention_case(
            3, b=1, hq=2 * group, hkv=2, s=s, d=d))
        want = plain_f32(q, k, v, causal, cap)
        ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
        for round_p in (True, False):
            got = kernel_tiles(q, k, v, causal, cap, round_p)
            dist = (got - want).abs().max().item() / ulp
            if dist > worst[round_p][0]:
                worst[round_p] = (dist, (s, d, 2 * group, 2, causal, cap))
    for round_p, (dist, case) in worst.items():
        print(f"P {'rounded to bf16' if round_p else 'kept in float32'}: "
              f"at most {dist:.4f} bf16 ulps at the top magnitude, at "
              f"(S, D, Hq, Hkv, causal, cap) = {case}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
