"""The manifest's checks, and the files found by name."""

import copy
import json
import os
import shutil
import time

import pytest

from nembench import run
from nembench.harness import loop
from nembench.harness import manifest as mf
from .nembench_cases import ROOT, book, cut_spec, few_threads  # noqa: F401



def test_committed_manifest_is_accepted(book):
    assert [w["name"] for w in book["workloads"]] == [
        "jupiter_ck.fwd_stream", "co_lbl.fwd_stream"]
    for m in book["per_layer"]:
        assert m["moves"] in {e["name"] for e in book["end_to_end"]}
        mf.metric(m["name"])
    for w in book["workloads"]:
        mf.config(w["config"])
        mf.traffic(w["traffic"])


def test_unknown_cell_is_refused(book):
    with pytest.raises(mf.ManifestError):
        mf.cell(book, "jupiter_ck.no_such_mix")


@pytest.mark.parametrize("where, key, value", [
    ("end_to_end", "name", "fwd waves"),
    ("end_to_end", "name", "a/b"),
    ("end_to_end", "unit", "waves per second"),
    ("end_to_end", "unit", "µs"),
    ("per_layer", "source", "guess"),
    ("workloads", "config", "no_such_config"),
])
def test_bad_entry_is_refused(book, where, key, value):
    bad = copy.deepcopy(book)
    bad[where][0][key] = value
    with pytest.raises(mf.ManifestError):
        mf.check(bad)


def test_new_metric_file_is_found_by_name(tmp_path, monkeypatch):
    shutil.copytree(os.path.join(ROOT, "nembench"), tmp_path / "nembench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "nembench" / "metrics" / "dummy_count.fwd.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    monkeypatch.setattr(mf, "ROOT", str(tmp_path))
    assert mf.metric("dummy_count.fwd").read(None) == 7.0
    with pytest.raises(mf.ManifestError):
        mf.metric("not_there")


def test_result_line_format(book, cut_spec):
    result = loop.run_cell(book, "jupiter_ck.fwd_stream", 2**31 + 11, 0.0,
                           False, "cpu", time.perf_counter(),
                           spec=cut_spec("jupiter_ck"), min_calls=2)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] >= 2
    assert set(line["metrics"]) == {"fwd_waves_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_exits_without_a_result(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    code = run.main(["--workload", "jupiter_ck.fwd_stream", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    assert code != 0
    assert capsys.readouterr().out == ""
