"""Long context through sequence parallelism: ring attention over ranks.

The sequence dimension is split across the ranks; K/V blocks rotate
around the ring (point-to-point hops) while each rank folds the visiting
blocks into a running softmax: exact attention, O(T/S) memory a rank, no
T x T scores anywhere.  On the card every hop is a flash-kernel call
(forward; dQ and dK/dV in the backward), the port's
:mod:`..parallel.ring_attention`.

    python -m distributed_deep_learning_tpu_torch.examples.02_long_context_ring_attention
    python -m distributed_deep_learning_tpu_torch.examples.02_long_context_ring_attention --cpu --ranks 2

At the JAX example's shape (B 2, T 4096, H 8, D 64, causal) the ranks
hold the whole batch and split T (every rank on the ring, where the JAX
example's 8 devices form data 2 x seq 4).  The pass condition is the JAX
example's: max|ring - dense| < 1e-4 against single-device dense attention
(the plain version, on rank 0).  The ring's gradients are held to the
dense gradients too, within 1e-3 of max|g| (``chip_smoke.py``'s flash
tolerance).
"""

import sys

from distributed_deep_learning_tpu_torch.examples import _bootstrap

MODULE = "distributed_deep_learning_tpu_torch.examples." \
    "02_long_context_ring_attention"


def main(argv=None) -> int:
    args = _bootstrap.parser(__doc__, ranks=True).parse_args(argv)
    if not _bootstrap.in_rank():
        return _bootstrap.launch(MODULE, args, argv)

    import torch
    import torch.distributed as dist

    from distributed_deep_learning_tpu_torch.parallel.ring_attention import (
        full_attention, ring_attention)
    from distributed_deep_learning_tpu_torch.runtime import bootstrap

    env, created = _bootstrap.process_group(args)
    try:
        S, rank, dev = env.world, env.rank, env.device
        B, T, H, D = 2, 4096, 8, 64         # T splits over the ranks
        Tl = T // S
        g = torch.Generator().manual_seed(0)
        q, k, v, w = (torch.randn(B, T, H, D, generator=g)
                      for _ in range(4))
        mine = slice(rank * Tl, (rank + 1) * Tl)
        ql, kl, vl = (t[:, mine].to(dev).requires_grad_()
                      for t in (q, k, v))
        out = ring_attention(ql, kl, vl, group=dist.group.WORLD, causal=True)
        (out * w[:, mine].to(dev)).sum().backward()
        parts = [out.detach(), ql.grad, kl.grad, vl.grad]
        whole = []
        for part in parts:                   # every rank's block, in order
            blocks = [torch.empty_like(part) for _ in range(S)]
            dist.all_gather(blocks, part.contiguous())
            whole.append(torch.cat(blocks, 1).cpu())
        if rank == 0:
            # the single-device O(T^2) check, one batch row at a time
            errs = [0.0] * 4
            for b in range(B):
                qd, kd, vd = (t[b:b + 1].to(dev).requires_grad_()
                              for t in (q, k, v))
                ref = full_attention(qd, kd, vd, causal=True)
                (ref * w[b:b + 1].to(dev)).sum().backward()
                for i, (got, want) in enumerate(zip(
                        whole, (ref.detach(), qd.grad, kd.grad, vd.grad))):
                    want = want.cpu()
                    diff = float((got[b:b + 1] - want).abs().max())
                    errs[i] = max(errs[i], diff if i == 0 else
                                  diff / float(want.abs().max()))
            err, grad_err = errs[0], max(errs[1:])
            print(f"ranks={S} on {dev}  T={T}  max|ring - dense| = "
                  f"{err:.2e}; dq/dk/dv rel {grad_err:.2e}")
            assert err < 1e-4
            assert grad_err < 1e-3
    finally:
        if created:
            bootstrap.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
