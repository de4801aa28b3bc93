"""One rank of the sharded cell with a fault planted under its timed
path, for the tests: ``fault_rank.py <fault> <rank arguments>``.

* ``no_exchange``: the gathers between ranks left out; each rank's own
  shard stands for every rank's.
* ``altered``: one byte of every file flipped.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from benchmark.drivers import sharded_encode  # noqa: E402
from jpeg_tpu_torch.parallel import sharded  # noqa: E402


def no_exchange(t, group, dim):
    return torch.cat([t] * dist.get_world_size(group), dim=dim)


def altered(assemble):
    def broken(self, *a, **k):
        out = []
        for data in assemble(self, *a, **k):
            f = bytearray(data)
            f[len(f) - 8] ^= 0x5A
            out.append(bytes(f))
        return out
    return broken


if __name__ == "__main__":
    fault = sys.argv[1]
    if fault == "no_exchange":
        sharded.all_gather_cat = no_exchange
    else:
        sharded.ShardedEncoder._assemble = altered(
            sharded.ShardedEncoder._assemble)
    sys.exit(sharded_encode.rank_main(sys.argv[2:]))
