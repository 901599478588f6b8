"""Two-process runs of ventjax_torch.dist over torch.distributed (gloo, on
the CPU): the counterparts of tests/test_multihost.py's halo CI and batch
mesh.  Each worker is its own process (tests/_torch_multihost_*_worker.py)
and checks its rank's results bit-equal to its own unsharded run."""
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(worker, marker, n=2, timeout=120):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, worker), str(port), str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert marker in out, out
    return [next(line for line in o.splitlines() if marker in line)
            for o in outs]


def test_two_process_halo_ci():
    """One shard per rank: each rank's CI slab is the unsharded map's."""
    lines = _run_ranks("_torch_multihost_halo_worker.py",
                       "TORCH_MULTIHOST_HALO_OK")
    nsat = {line.split("nsat=")[1].split()[0] for line in lines}
    assert len(nsat) == 1, lines   # the all-reduced count, the same


def test_two_process_batch_mesh():
    """The batch-sharded analyze_cohort: each rank's lanes are its own
    unsharded run's, and both ranks hold the same gathered metrics."""
    lines = _run_ranks("_torch_multihost_cohort_worker.py",
                       "TORCH_MULTIHOST_OK")
    assert len({line.split("vdp=")[1] for line in lines}) == 1, lines


@pytest.mark.parametrize("backend", [None, "gloo"])
def test_initialize_multihost_backend_on_the_cpu(backend, tmp_path):
    """Without a card the default backend is gloo; one process at world
    size 1 initialises, all-reduces and tears down."""
    code = (
        "import sys, torch, torch.distributed as d\n"
        f"sys.path.insert(0, {os.path.dirname(HERE)!r})\n"
        "from ventjax_torch.dist import initialize_multihost\n"
        f"initialize_multihost('localhost:{_free_port()}', 1, 0, "
        f"backend={backend!r})\n"
        "t = torch.ones(3)\n"
        "d.all_reduce(t)\n"
        "print(d.get_backend(), d.get_world_size(), t.tolist())\n"
        "d.destroy_process_group()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "gloo 1 [1.0, 1.0, 1.0]"
