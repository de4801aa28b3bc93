"""Rank processes of the port's multi-process CPU tests, and their
launcher.

``spawn_ranks`` starts ``world`` copies of this file, one per rank of a
gloo group, and returns each rank's result.  A rank reads its job's
input (a pickle the parent wrote), joins the group, runs the job through
``jpeg_tpu_torch`` on the CPU (the kernels' plain twins) and writes its
result as a pickle for the parent.  Ranks import torch and the port,
never jax or ``jpeg_tpu``: the parent holds their results against
``jpeg_tpu``.

    python tests/torch_parallel_worker.py JOB RANK WORLD RENDEZVOUS IN OUT

``RENDEZVOUS``: a ``FileStore`` path ("sharded", "decode"), or the
"host:port" of ``parallel.distributed.initialize`` ("initialize").
"""
from __future__ import annotations

import os
import pickle
import sys

SPAWN_TIMEOUT_S = 120


def spawn_ranks(job: str, world: int, tmp_path, spec: dict,
                rendezvous: str | None = None,
                timeout_s: float = SPAWN_TIMEOUT_S) -> list:
    """Run ``job`` on ``world`` gloo ranks -> each rank's result, in rank
    order.  All ranks are killed, and the call fails with their stderr,
    if any rank fails or the ranks do not all finish within ``timeout_s``
    (a hung rendezvous included: ``parallel.launch.run_ranks``)."""
    from jpeg_tpu_torch import native
    from jpeg_tpu_torch.parallel.launch import run_ranks
    native.load()  # built once here, not raced by the ranks
    inp = tmp_path / f"{job}.in.pkl"
    with open(inp, "wb") as f:
        pickle.dump(spec, f)
    rendezvous = rendezvous or str(tmp_path / f"{job}.store")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["OMP_NUM_THREADS"] = "1"
    outs = [tmp_path / f"{job}.rank{r}.pkl" for r in range(world)]
    logs = tmp_path / f"{job}.logs"
    logs.mkdir()
    run_ranks([[sys.executable, os.path.abspath(__file__), job, str(r),
                str(world), rendezvous, str(inp), str(outs[r])]
               for r in range(world)], str(logs), timeout_s, env=env,
              cwd=root)
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


# -- the jobs (run in the ranks) ---------------------------------------------


def _sharded(spec: dict) -> dict:
    """Each case of ``spec["cases"]`` through ``ShardedEncoder`` on a 2x2
    mesh: name -> files, or (words, totals, hists) of ``step``."""
    from jpeg_tpu_torch import EncodeConfig
    from jpeg_tpu_torch.parallel.mesh import make_mesh
    from jpeg_tpu_torch.parallel.sharded import ShardedEncoder
    mesh = make_mesh(data=2, space=2, device="cpu")
    out = {}
    for case in spec["cases"]:
        batch = case["batch"]
        enc = ShardedEncoder(mesh, batch.shape[1], batch.shape[2],
                             config=EncodeConfig(**case["config"]),
                             segs_per_device=case["spd"])
        if case.get("step"):
            out[case["name"]] = tuple(t.numpy() for t in enc.step(batch))
        else:
            out[case["name"]] = enc.encode_batch(batch)
    return out


def _decode(spec: dict) -> dict:
    """Each case of ``spec["cases"]`` decoded over a 1 x world space mesh:
    name -> list of uint8 images."""
    import torch.distributed as dist
    from jpeg_tpu_torch import decode_jpeg_batch
    from jpeg_tpu_torch.parallel.mesh import make_mesh
    from jpeg_tpu_torch.pipelines.speculative import \
        speculative_decode_restart
    mesh = make_mesh(data=1, space=dist.get_world_size(), device="cpu")
    out = {}
    for name, kind, datas in spec["cases"]:
        if kind == "restart-spec":
            imgs = [speculative_decode_restart(
                d, device="cpu", mesh=mesh,
                target_lane_bytes=spec["lane_bytes"]) for d in datas]
        else:
            imgs = decode_jpeg_batch(datas, entropy_engine="device",
                                     device="cpu", mesh=mesh)
        out[name] = [im.numpy() for im in imgs]
    return out


def _initialize(argv) -> dict:
    """``initialize`` over TCP (the second call a no-op), ``global_mesh``,
    an ``all_reduce`` over the mesh, and this process's slice of a global
    batch encoded by the port."""
    import torch
    import torch.distributed as dist
    from jpeg_tpu_torch import EncodeConfig, JpegEncoder
    from jpeg_tpu_torch.parallel import distributed as pdist
    rank, world, addr, spec = argv
    pdist.initialize(coordinator_address=addr, num_processes=world,
                     process_id=rank, device="cpu")
    pdist.initialize(device="cpu")  # idempotent: already initialized
    mesh = pdist.global_mesh(space_per_host=2)
    total = torch.full((4,), float(rank + 1))
    dist.all_reduce(total, group=mesh.get_group("space"))
    sl = pdist.process_batch_slice(spec["batch"].shape[0])
    try:
        pdist.process_batch_slice(world + 1)
        odd = None
    except ValueError as e:
        odd = str(e)
    enc = JpegEncoder(EncodeConfig(scan_layout="interleaved"), device="cpu")
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "mesh": tuple(mesh.shape), "dims": mesh.mesh_dim_names,
            "total": total.tolist(), "slice": (sl.start, sl.stop),
            "odd": odd,
            "files": [enc.encode(spec["batch"][i])
                      for i in range(sl.start, sl.stop)]}


def main() -> None:
    job, rank, world, rendezvous, inp, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    with open(inp, "rb") as f:
        spec = pickle.load(f)
    import torch.distributed as dist
    if job == "initialize":
        result = _initialize((rank, world, rendezvous, spec))
    else:
        dist.init_process_group("gloo", store=dist.FileStore(rendezvous,
                                                              world),
                                rank=rank, world_size=world)
        result = {"sharded": _sharded, "decode": _decode}[job](spec)
    dist.barrier()
    dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main()
