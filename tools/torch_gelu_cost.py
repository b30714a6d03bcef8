#!/usr/bin/env python3
"""What the port's JAX-exact tanh-GELU and f32 neighbour gather cost on the card.

    python3 tools/torch_gelu_cost.py

Times, with CUDA events, one forward and backward of each variant on the
SAGE message tensor [N, K, H] bf16 of the training cell (16384 hosts,
K=16, hidden 512) and of the trainer service (hidden 256): torch's fused
``F.gelu(approximate="tanh")`` against ``models.graphsage.gelu`` (JAX's
op-for-op form), and the neighbour gather of [N, H] rows in bf16 against
the f32 gather the SAGE layer runs. Prints one JSON line with the card's
name and power limit, the mean ms of each and its peak device memory.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dragonfly2_tpu_torch.models.graphsage import gelu  # noqa: E402
from dragonfly2_tpu_torch.ops.neighbor_agg import neighbor_gather  # noqa: E402

N, K, ITERS = 16384, 16, 20


def timed(fn) -> tuple[float, int]:
    """Mean device ms of fn() over ITERS back-to-back runs, and its peak
    device memory above what was allocated before."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS, torch.cuda.max_memory_allocated() - base


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gelu_cost: no CUDA device is present", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card, "iters": ITERS}
    for hidden in (512, 256):
        x = torch.randn((N, K, hidden), device="cuda", generator=gen).mul_(2).to(torch.bfloat16).requires_grad_(True)
        g = torch.randn((N, K, hidden), device="cuda", generator=gen).to(torch.bfloat16)
        u = torch.randn((N, hidden), device="cuda", generator=gen).to(torch.bfloat16).requires_grad_(True)
        nbr = torch.randint(0, N, (N, K), device="cuda", generator=gen, dtype=torch.int32)

        def fused():
            torch.autograd.grad(torch.nn.functional.gelu(x, approximate="tanh"), x, g)

        def jax_exact():
            torch.autograd.grad(gelu(x), x, g)

        def gather_bf16():
            torch.autograd.grad(neighbor_gather(u, nbr), u, g)

        def gather_f32():
            torch.autograd.grad(neighbor_gather(u.float(), nbr).to(torch.bfloat16), u, g)

        for name, fn in (("F.gelu", fused), ("jax_exact_gelu", jax_exact),
                         ("gather_bf16", gather_bf16), ("gather_f32", gather_f32)):
            ms, peak = timed(fn)
            out[f"{name}_h{hidden}_ms"] = ms
            out[f"{name}_h{hidden}_peak_bytes"] = peak
        del x, g, u, nbr
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
