"""``BENCHMARK.json``: its checks, and the files each name stands for.

A configuration ``<name>`` is ``configs/<name>.json`` (its sizes) with
``configs/<name>.py`` (its program and reference sides), a traffic mix is
``traffic/<name>.json``, the kind of call a mix makes is
``calls/<name>.py``, a per-layer metric is ``metrics/<name>.py``; each
is found by the name alone, so a new cell or metric is new files and new
entries, with no edit to a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class ManifestError(ValueError):
    """A manifest that the benchmark refuses."""


def _text(value, what):
    if (not isinstance(value, str) or not 1 <= len(value) <= 200
            or "\n" in value or "\t" in value):
        raise ManifestError(f"{what}: 1 to 200 characters on one line")


def _name(value, what):
    if not isinstance(value, str) or not NAME.match(value):
        raise ManifestError(f"{what}: bad name {value!r}")


def check(manifest: dict) -> dict:
    """Raise ``ManifestError`` for a manifest outside the benchmark's rules;
    return it unchanged otherwise."""
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(manifest) != keys:
        raise ManifestError(f"keys must be exactly {sorted(keys)}")
    if not (isinstance(manifest["run_seconds"], int)
            and 1 <= manifest["run_seconds"] <= 51):
        raise ManifestError("run_seconds: a whole number from 1 to 51")
    for word in manifest["command"]:
        _text(word, "command")
    configs = {}
    for c in manifest["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            raise ManifestError(f"config {c.get('name')}: bad keys")
        _name(c["name"], "config")
        _text(c["source"], "source")
        _text(c["why"], "why")
        for k in c["reduced"]:
            _name(k, "reduced key")
        if c["name"] in configs:
            raise ManifestError(f"config {c['name']} twice")
        configs[c["name"]] = c
    cells, pairs = {}, set()
    for w in manifest["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            raise ManifestError(f"workload {w.get('name')}: bad keys")
        for k in ("name", "config", "traffic"):
            _name(w[k], f"workload {k}")
        _text(w["why"], "why")
        if w["config"] not in configs:
            raise ManifestError(f"workload {w['name']}: unknown config")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: chips is 1 or 4")
        if w["name"] in cells or (w["config"], w["traffic"]) in pairs:
            raise ManifestError(f"workload {w['name']} twice")
        cells[w["name"]] = w
        pairs.add((w["config"], w["traffic"]))
    seen = set()
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            _name(m.get("name"), "metric")
            if m["name"] in seen:
                raise ManifestError(f"metric {m['name']} twice")
            seen.add(m["name"])
            if not isinstance(m.get("unit"), str) or not UNIT.match(m["unit"]):
                raise ManifestError(f"metric {m['name']}: bad unit")
            if m.get("better") not in ("lower", "higher"):
                raise ManifestError(f"metric {m['name']}: better?")
            if m.get("source") not in SOURCES:
                raise ManifestError(f"metric {m['name']}: bad source")
            for cell in m.get("workloads", ()):
                if cell not in cells:
                    raise ManifestError(
                        f"metric {m['name']}: unknown workload {cell}")
    return manifest


def load(path: str | None = None) -> dict:
    """The checked manifest at ``path`` (default: ``BENCHMARK.json`` at the
    root of the checkout)."""
    path = path or os.path.join(ROOT, "BENCHMARK.json")
    with open(path) as f:
        return check(json.load(f))


def cell(manifest: dict, name: str) -> dict:
    """The workload ``name``, or ``ManifestError``."""
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise ManifestError(f"unknown workload {name!r}")


def metrics_of(manifest: dict, kind: str, cell_name: str) -> list:
    """The ``kind`` metrics that the cell ``cell_name`` reports."""
    return [m for m in manifest[kind]
            if cell_name in m.get("workloads", (cell_name,))]


def _file(kind: str, name: str, suffix: str) -> str:
    _name(name, kind)
    path = os.path.join(ROOT, "nembench", kind, name + suffix)
    if not os.path.isfile(path):
        raise ManifestError(f"no {kind} file for {name!r}")
    return path


def _module(path: str, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config(name: str):
    """(sizes, module) of the configuration ``name``."""
    with open(_file("configs", name, ".json")) as f:
        sizes = json.load(f)
    return sizes, _module(_file("configs", name, ".py"),
                          f"nembench_config_{name.replace('.', '_')}")


def traffic(name: str) -> dict:
    """The parameters of the traffic mix ``name``."""
    with open(_file("traffic", name, ".json")) as f:
        return json.load(f)


def call(name: str):
    """The module of the kind of call ``name`` (the timed call, its
    end-to-end metrics and its comparison with the reference)."""
    return _module(_file("calls", name, ".py"),
                   f"nembench_call_{name.replace('.', '_')}")


def metric(name: str):
    """The reader module of the per-layer metric ``name``."""
    return _module(_file("metrics", name, ".py"),
                   f"nembench_metric_{name.replace('.', '_')}")
