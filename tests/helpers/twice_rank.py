"""Test helper: a rank of the port that makes its default process group,
sums its rank over the group, destroys the group and does it all again
(two rendezvous in one process, through one launcher's store)."""
import torch
import torch.distributed as dist

from distributed_deep_learning_tpu_torch.runtime import bootstrap

sums = []
for _ in range(2):
    env, created = bootstrap.initialize("cpu")
    t = torch.tensor([float(env.rank + 1)])
    dist.all_reduce(t)
    sums.append(int(t.item()))
    bootstrap.shutdown()
print(f"SUMS {sums} created {created}", flush=True)
