"""The utilities of the PyTorch port against the JAX package: the
package-wide logging stack (``cfg/``, mirroring
``tests/test_observability.py`` on the port's logger), the maths helpers
(``utils/maths.py``), the profiling module (``utils/profiling.py``:
``Timings``, ``stopwatch`` on CPU tensors, ``trace`` and
``device_memory_report`` asked for the CPU) and the data helpers of
``utils/datafiles.py`` (``gas_name``, ``calc_mmw``, ``data_root``; the
counterparts of the JAX package's ``data/__init__.py`` and
``data/datadir.py``)."""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch

from archnemesis_tpu import data as jdata
from archnemesis_tpu.data import datadir as jdatadir
from archnemesis_tpu.utils import maths as jmaths
from archnemesis_tpu.utils import profiling as jprofiling
from archnemesis_tpu_torch.cfg import (
    pkg_logger,
    pop_packagewide_level,
    push_packagewide_level,
    quiet,
    set_packagewide_level,
)
from archnemesis_tpu_torch.utils import datafiles, maths, profiling


# --- logging

def test_pkg_logger_is_the_port_s():
    assert pkg_logger.name == "archnemesis_tpu_torch"
    assert pkg_logger.propagate is False and pkg_logger.handlers
    assert logging.getLogger("archnemesis_tpu") is not pkg_logger


def test_push_pop_level_stack():
    child = logging.getLogger("archnemesis_tpu_torch.test_child")
    child.setLevel(logging.DEBUG)
    before = (pkg_logger.level, child.level)
    push_packagewide_level(logging.ERROR)
    assert pkg_logger.level == logging.ERROR
    assert child.level == logging.ERROR
    pop_packagewide_level()
    assert (pkg_logger.level, child.level) == before
    with pytest.raises(RuntimeError, match="without matching push"):
        pop_packagewide_level()


def test_quiet_context_max_mode():
    child = logging.getLogger("archnemesis_tpu_torch.test_child2")
    child.setLevel(logging.CRITICAL)
    with quiet(logging.WARNING):
        # 'min' mode must not lower an already-stricter logger
        assert child.level == logging.CRITICAL
        assert pkg_logger.level >= logging.WARNING
    set_packagewide_level(logging.INFO)


def test_set_level_modes():
    child = logging.getLogger("archnemesis_tpu_torch.test_child3")
    child.setLevel(logging.DEBUG)
    set_packagewide_level(logging.WARNING, mode="min")
    assert child.level == logging.WARNING
    set_packagewide_level(logging.INFO, mode="max")
    assert child.level == logging.INFO
    with pytest.raises(ValueError, match="unknown mode"):
        set_packagewide_level(logging.INFO, mode="other")
    set_packagewide_level(logging.INFO)


# --- maths

def test_maths_match_jax():
    rng = np.random.default_rng(11)
    diag = np.diag(rng.uniform(1, 2, 5))
    off = diag.copy()
    off[1, 3] = 1e-300
    for a in (diag, off, np.ones((2, 3)), np.zeros((0, 0)), np.ones(4)):
        before = a.copy()
        assert maths.is_diagonal(a) == jmaths.is_diagonal(a)
        np.testing.assert_array_equal(a, before)  # not clobbered
    assert maths.is_diagonal(diag) and not maths.is_diagonal(off)
    for a in (np.cumsum(rng.uniform(0.1, 1, 9)), np.array([1.0, 1.0, 5.0]),
              rng.normal(size=(3, 6))):
        for axis in (-1, 0):
            assert (maths.is_monotonically_increasing(a, axis=axis)
                    == jmaths.is_monotonically_increasing(a, axis=axis))
    x = np.linspace(-5, 5, 1001)
    for amp, mean, fwhm in ((2.0, -1.0, 0.5),
                            ([2.0, 1.0], [-1.0, 2.0], [0.5, 1.0]),
                            (rng.uniform(0, 3, 4), rng.normal(size=4),
                             rng.uniform(0.2, 2, 4))):
        np.testing.assert_array_equal(maths.ngauss(x, amp, mean, fwhm),
                                      jmaths.ngauss(x, amp, mean, fwhm))


# --- profiling

def test_timings_summary_and_report_match_jax():
    samples = [("forward", 0.125), ("jacobian", 1.5), ("forward", 0.25),
               ("update", 0.0625)]
    got, want = profiling.Timings(), jprofiling.Timings()
    for name, s in samples:
        got.add(name, s)
        want.add(name, s)
    assert got.summary() == want.summary()
    assert got.report() == want.report()
    got.clear()
    assert got.summary() == {}


@dataclasses.dataclass
class _Held:
    k: torch.Tensor


def test_stopwatch_on_a_cpu_tensor_result():
    reg = profiling.Timings()
    with profiling.stopwatch("matmul", registry=reg) as box:
        box[0] = {"y": [torch.ones(64, 64) @ torch.ones(64, 64)],
                  "held": _Held(torch.zeros(2)), "n": 3}
    s = reg.summary()["matmul"]
    assert s["count"] == 1 and s["total_s"] > 0
    assert "matmul" in reg.report()
    found = list(profiling._tensors(box[0]))
    assert len(found) == 2
    with profiling.stopwatch("none", registry=reg):
        pass
    assert reg.summary()["none"]["count"] == 1


def test_trace_and_memory_report_on_the_cpu(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir), device="cpu") as prof:
        with profiling.annotate("test-region"):
            (torch.arange(8.0) * 2).sum()
    assert prof is not None
    with open(logdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "test-region" for e in events)
    assert profiling.device_memory_report(device="cpu") == {}
    # annotate outside a trace is harmless, as in the JAX package
    with profiling.annotate("outside"):
        pass


# --- data helpers

def _outcome(fn, *args):
    """fn(*args), or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 (compared between packages)
        return type(e)


def test_gas_name_and_calc_mmw_match_jax():
    info = datafiles.gas_info()
    named = 0
    for gid, gi in info.items():
        assert datafiles.gas_name(int(gid)) == jdata.gas_name(int(gid))
        for iso in gi["isotope"]:
            got = _outcome(datafiles.gas_name, int(gid), int(iso))
            assert got == _outcome(jdata.gas_name, int(gid), int(iso))
            named += isinstance(got, str)
    assert named > 100  # some isotopes carry no name: KeyError in both
    ids = [int(g) for g in info]
    vmr = np.random.default_rng(2).uniform(0, 1, len(ids))
    assert datafiles.calc_mmw(vmr, ids) == jdata.calc_mmw(vmr, ids)
    assert datafiles.calc_mmw(vmr[:3], ids[:3], [1, 1, 1]) == \
        jdata.calc_mmw(vmr[:3], ids[:3], [1, 1, 1])


def test_data_root_matches_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("ARCHNEMESIS_TPU_DATA", raising=False)
    assert os.path.samefile(datafiles.data_root(), jdatadir.data_root())
    assert datafiles.data_path("cia", "x.tab") == os.path.join(
        datafiles.data_root(), "cia", "x.tab")
    monkeypatch.setenv("ARCHNEMESIS_TPU_DATA", str(tmp_path))
    assert datafiles.data_root() == jdatadir.data_root() == str(tmp_path)
    assert datafiles.data_path("stellar", "a") == jdatadir.data_path(
        "stellar", "a")
