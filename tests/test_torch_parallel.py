"""The port's mesh and multi-process helpers (``jpeg_tpu_torch.parallel``)
against ``jpeg_tpu.parallel``'s rules: single-process paths in this
process, and a real two-process ``initialize`` over TCP with gloo."""
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from jpeg_tpu.pipelines.encode import JpegEncoder as JaxJpegEncoder
from jpeg_tpu_torch.parallel import distributed as pdist
from jpeg_tpu_torch.parallel import mesh as pmesh
from torch_parallel_worker import spawn_ranks

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture
def no_group(monkeypatch):
    """A process with no group and no torchrun environment; any group a
    test brings up is destroyed after it."""
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("data,space", [(2, 2), (1, 3), (9, 1)])
def test_make_mesh_needs_the_ranks(no_group, data, space):
    """Too few ranks: ``jpeg_tpu``'s message with the world's size, and no
    group brought up."""
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(data=data, space=space, devices=[object()])
    with pytest.raises(ValueError) as err:
        pmesh.make_mesh(data=data, space=space, device="cpu")
    assert str(err.value) == str(jax_err.value)
    assert not dist.is_initialized()


def test_make_mesh_on_the_card_needs_one(no_group, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    assert not dist.is_initialized()


def test_one_by_one_mesh_without_initialize(no_group):
    """A 1x1 mesh brings up its own world-size-1 gloo group (an in-process
    store, no port); its groups run collectives, and a mesh of the card's
    type is refused on that group."""
    mesh = pmesh.make_mesh(device="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert mesh.mesh_dim_names == (pmesh.DATA_AXIS, pmesh.SPACE_AXIS)
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    assert list(mesh.get_coordinate()) == [0, 0]
    t = torch.arange(4, dtype=torch.int32)
    dist.all_reduce(t, group=mesh.get_group(pmesh.SPACE_AXIS))
    assert t.tolist() == [0, 1, 2, 3]
    got = pmesh.all_gather_cat(t[None], mesh.get_group(pmesh.DATA_AXIS), 0)
    assert got.tolist() == [[0, 1, 2, 3]]
    assert pmesh.make_mesh().device_type == "cpu"  # follows the group
    with pytest.raises(ValueError, match="runs gloo"):
        pmesh.make_mesh(device="cuda")
    assert [type(p).__name__ for p in pmesh.batch_sharding(mesh)] == \
        ["Shard", "Shard"]
    assert [p.dim for p in pmesh.batch_sharding(mesh)] == [0, 1]
    assert [type(p).__name__ for p in pmesh.replicated(mesh)] == \
        ["Replicate", "Replicate"]


def test_initialize_is_noop_single_process(no_group):
    pdist.initialize()  # nothing given or set: a single-process run
    pdist.initialize(device="cpu")
    assert not dist.is_initialized()
    assert pdist.process_batch_slice(32) == slice(0, 32)


def test_initialize_needs_all_three(no_group, monkeypatch):
    with pytest.raises(ValueError, match="needs a coordinator address"):
        pdist.initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="needs a coordinator address"):
        pdist.initialize(coordinator_address="localhost:1",
                         num_processes=2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="needs a coordinator address"):
        pdist.initialize(device="cpu")
    assert not dist.is_initialized()


def test_initialize_retries_then_raises_the_last_error(no_group,
                                                      monkeypatch):
    """A failing rendezvous is re-attempted ``retries`` times with
    exponential backoff, then its last error is raised."""
    calls, sleeps = [], []

    def refuse(backend, **kw):
        calls.append((backend, kw))
        raise RuntimeError(f"connect refused {len(calls)}")
    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(pdist.time, "sleep", sleeps.append)
    with pytest.raises(RuntimeError, match="connect refused 3"):
        pdist.initialize(coordinator_address="localhost:29500",
                         num_processes=2, process_id=1, device="cpu",
                         retries=2, backoff_s=0.5)
    assert sleeps == [0.5, 1.0]
    assert calls[0] == ("gloo", dict(init_method="tcp://localhost:29500",
                                     world_size=2, rank=1))


def test_global_mesh_single_process(no_group, monkeypatch):
    mesh = pdist.global_mesh(device="cpu")
    assert tuple(mesh.shape) == (1, 1)


def test_two_process_tcp_run(tmp_path):
    """A real ``initialize`` across two CPU processes over TCP: the second
    call is a no-op, ``global_mesh(space_per_host=2)`` keeps both ranks on
    ``space``, an ``all_reduce`` over it sums both, each process encodes
    its ``process_batch_slice`` of a shared batch (a batch of 3 is
    refused), and the files equal ``jpeg_tpu``'s of the same images."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    batch = np.random.default_rng(42).integers(
        0, 256, size=(4, 64, 64, 3)).astype(np.uint8)
    reports = spawn_ranks("initialize", 2, tmp_path, {"batch": batch},
                          rendezvous=f"localhost:{port}")
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["world"] == 2 and r["mesh"] == (1, 2)
        assert r["dims"] == ("data", "space")
        assert r["total"] == [3.0] * 4
        assert r["odd"] == ("batch size 3 must be divisible by the 2 "
                            "processes (pad the batch or drop the "
                            "remainder explicitly)")
    assert [r["slice"] for r in reports] == [(0, 2), (2, 4)]
    enc = JaxJpegEncoder(JaxConfig(scan_layout="interleaved"))
    want = [bytes(enc.encode(img)) for img in batch]
    assert reports[0]["files"] + reports[1]["files"] == want


@pytest.mark.parametrize("rank1,timeout_s,why", [
    ("import sys; print('rank 1 broke', file=sys.stderr); sys.exit(3)",
     40, "a rank failed"),
    ("import time; time.sleep(60)", 2, "killed after 2 s"),
])
def test_run_ranks_kills_every_rank_and_raises(tmp_path, rank1, timeout_s,
                                               why):
    """``parallel.launch.run_ranks``: a rank that fails, or one that
    outlives the deadline, gets every rank killed (the healthy rank 0
    waits forever) and raises with each rank's exit code and stderr."""
    import sys
    import time
    from jpeg_tpu_torch.parallel.launch import run_ranks
    wait = "import time; time.sleep(60)"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_ranks([[sys.executable, "-c", wait],
                   [sys.executable, "-c", rank1]], str(tmp_path),
                  timeout_s)
    assert time.monotonic() - t0 < 30
    assert why in str(err.value)
    assert "rank 0 exited" in str(err.value)
    if "broke" in rank1:
        assert "rank 1 exited 3:\nrank 1 broke" in str(err.value)


def test_run_ranks_waits_for_every_rank(tmp_path):
    import sys
    from jpeg_tpu_torch.parallel.launch import run_ranks
    outs = [tmp_path / f"out{r}" for r in range(3)]
    run_ranks([[sys.executable, "-c",
                f"open({str(o)!r}, 'w').write('{r}')"]
               for r, o in enumerate(outs)], str(tmp_path), 60)
    assert [o.read_text() for o in outs] == ["0", "1", "2"]
