"""The frame-chain perf lab's command line (``tools/perf_lab.py:main``) of
the PyTorch port, on the CPU.

* ``main`` at ``--shape 64x80 --device cpu``: every experiment timed, finite
  and positive, the frames/s of the chain experiments, the printed table;
  an unknown experiment raises.
* Asked for nothing, the lab runs on the card: without one it raises.

Split from ``tests/test_torch_anchor.py``, which holds K9 and the lab's
chains against the JAX package: ``main`` times every experiment, and under
six pytest-xdist workers it was the longest part of that file.
"""

import numpy as np
import pytest
import torch

from maze_image_processing_pipeline_tpu_torch.tools import perf_lab


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores, and
    torch's per-worker thread pools oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lab_main_runs_on_the_cpu(capsys):
    results = perf_lab.main(["--shape", "64x80", "--device", "cpu"])
    assert set(results) == set(perf_lab.EXPERIMENTS) | {f"{e}_fps" for e in perf_lab.EXPERIMENTS
                                                       if e.startswith("chain")}
    assert all(np.isfinite(v) and v > 0 for v in results.values())
    out = capsys.readouterr().out
    assert "batch=(8, 64, 80)" in out and "ms/batch" in out and "frames/s" in out
    with pytest.raises(ValueError, match="unknown experiments"):
        perf_lab.main(["props16", "--device", "cpu"])


def test_lab_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        perf_lab.main(["morph", "--shape", "64x80"])
