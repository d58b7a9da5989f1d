"""`import repro_torch` guards torch's CPU vector math against its first-call
race (ROADMAP C).

The first parallel call of a vector-math function in a process raced in
the library's first-use set-up between OpenMP threads: a first
`torch.logsumexp` over 21000 f32 values differed from the second in 3 of
40 fresh processes, started 8 at a time. The package runs one serial exp
at import, after which no process differed.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

_FIRST_LOGSUMEXP = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import repro_torch
rng = np.random.default_rng(int(sys.argv[2]))
x = torch.from_numpy(rng.standard_normal((21, 1000), dtype=np.float32))
first = torch.logsumexp(x, dim=-1)
print(int((first != torch.logsumexp(x, dim=-1)).sum()))
"""


def test_first_logsumexp_after_import_is_thread_independent():
    """32 fresh processes, 8 at a time: each imports the package, makes its
    input with numpy (no torch math before the call under test) and
    compares its first `torch.logsumexp` with its second, bitwise. Without
    the guard, at 3 of 40, 32 processes would show the race with
    P ≈ 0.9."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src}
    width = 8
    diffs = []
    for start in range(0, 32, width):
        procs = [subprocess.Popen(
            [sys.executable, "-c", _FIRST_LOGSUMEXP, src, str(start + i)],
            stdout=subprocess.PIPE, env=env, text=True)
            for i in range(width)]
        try:
            for p in procs:
                out, _ = p.communicate(timeout=300)
                assert p.returncode == 0
                diffs.append(int(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    assert len(diffs) == 32
    assert diffs == [0] * 32, diffs
