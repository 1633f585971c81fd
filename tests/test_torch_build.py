"""The kernel build's process handling (``kernels/build.py``) with a
stand-in for ``nvcc``: ``start_all`` returns while the compiles run,
``build_all`` and ``load`` wait for the runs it started instead of
starting them again, and ``stop_all`` ends the runs nobody waited for.
The real compiles run only where the CUDA toolkit is (``chip_smoke.py``)."""
import os
import stat
import time

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

# writes its "-o" target after SLEEP seconds, prints a ptxas-like log line,
# and counts its runs in RUNS
FAKE_NVCC = """#!/bin/sh
echo run >> "$RUNS"
sleep "$SLEEP"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "ptxas info : Used 32 registers"
echo built > "$out"
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    tool = tmp_path / "nvcc"
    tool.write_text(FAKE_NVCC)
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    runs = tmp_path / "runs"
    monkeypatch.setenv("RUNS", str(runs))
    monkeypatch.setattr(build, "_tool", lambda name: str(tool))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_RUNNING", {})
    monkeypatch.setattr(build, "_LIBS", {})
    return runs


def _runs(path):
    return len(path.read_text().split()) if path.exists() else 0


def test_start_all_returns_while_nvcc_runs_and_build_all_waits(fake, monkeypatch):
    monkeypatch.setenv("SLEEP", "1")
    names = ["quant_matmul", "flash_attention"]
    t0 = time.time()
    build.start_all(names)
    assert time.time() - t0 < 0.9 and sorted(build._RUNNING) == sorted(names)
    assert not any(build._target(n).exists() for n in names)
    logs = build.build_all(names)
    assert all("Used 32 registers" in logs[n] for n in names)
    assert all(build._target(n).read_text() == "built\n" for n in names)
    assert not build._RUNNING and _runs(fake) == 2
    # built: another build_all finds the libraries and starts nothing
    assert build.build_all(names) == logs and _runs(fake) == 2


def test_load_waits_for_the_run_start_all_began(fake, monkeypatch):
    monkeypatch.setenv("SLEEP", "0.5")
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    build.start_all(["block_sparse"])
    lib = build.load("block_sparse")
    assert lib == ("lib", str(build._target("block_sparse"))) and _runs(fake) == 1


def test_stop_all_kills_the_runs_nobody_waited_for(fake, monkeypatch):
    monkeypatch.setenv("SLEEP", "30")
    build.start_all(["paged_attention"])
    _, tmp, proc = build._RUNNING["paged_attention"]
    for _ in range(100):                 # until the stand-in runs its own child
        if len(_running_in_group(proc.pid)) > 1:
            break
        time.sleep(0.05)
    assert len(_running_in_group(proc.pid)) > 1
    t0 = time.time()
    build.stop_all()
    assert time.time() - t0 < 10 and proc.poll() is not None
    assert not build._RUNNING and not os.path.exists(tmp)
    assert not build._target("paged_attention").exists()
    # the stand-in's own child (its sleep) went with it: nothing of its
    # session runs on (a killed child may linger as a zombie until reaped)
    for _ in range(50):
        if not _running_in_group(proc.pid):
            break
        time.sleep(0.1)
    assert not _running_in_group(proc.pid)


def _running_in_group(pgid):
    """Pids of process group ``pgid`` that are not zombies (from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            out.append(int(d))
    return out
