"""The port's PTB-XL fetcher (ptbxl_torch/data/fetch.py) and CLI 01
(ptbxl_torch/cli/download_missing_records.py) against ptbxl_tpu/data/fetch.py.

JAX's seven cases (tests/test_fetch.py) with the same scripted opener: each
runs both packages on identical copies of the mirror and holds their reports,
requests, logs and files equal.  Then CLI 01's exit codes, and one run over a
loopback HTTP server through the real ``urllib`` opener.  No network.
"""

import functools
import http.server
import io
import os
import shutil
import threading
import urllib.error

import pytest

from ptbxl_tpu.data import fetch as jax_fetch

from ptbxl_torch.cli import download_missing_records as cli01
from ptbxl_torch.data import fetch
from ptbxl_torch.utils.table import write_csv

PKGS = {"port": fetch, "jax": jax_fetch}


def _make_mirror(root, rel_paths, present=(), column="filename_hr"):
    """Write a ptbxl_database.csv naming rel_paths; create files in `present`."""
    os.makedirs(root, exist_ok=True)
    write_csv(os.path.join(root, "ptbxl_database.csv"),
              {column: list(rel_paths), "ecg_id": list(range(len(rel_paths)))})
    for rel in present:
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(b"x")


class FakeHTTP:
    """Scripted opener: maps url -> list of outcomes (bytes or Exception)."""

    def __init__(self, script):
        self.script = {k: list(v) for k, v in script.items()}
        self.calls = []

    def __call__(self, url):
        self.calls.append(url)
        outcome = self.script[url].pop(0)
        if isinstance(outcome, Exception):
            raise outcome
        return io.BytesIO(outcome)


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _both(tmp_path, build, call):
    """Run ``call(module, root)`` on a fresh mirror from ``build(root)`` for each
    package; return {pkg: (result, files, logs)}."""
    out = {}
    for name, mod in PKGS.items():
        root = str(tmp_path / name)
        build(root)
        logs = []
        result = call(mod, root, logs.append)
        out[name] = (result, _tree(root), [ln.replace(root, "<root>") for ln in logs])
    assert out["port"] == out["jax"]
    return out["port"]


def test_scan_missing_detects_incomplete_pairs(tmp_path):
    rels = ["records500/00000/00001_hr", "records500/00000/00002_hr",
            "records500/00000/00003_hr"]
    present = ["records500/00000/00001_hr.hea", "records500/00000/00001_hr.dat",
               "records500/00000/00002_hr.hea"]  # 1 complete, 2 lacks .dat
    got, _, _ = _both(tmp_path, lambda r: _make_mirror(r, rels, present),
                      lambda mod, root, log: mod.scan_missing(root))
    assert got == rels[1:]


def test_scan_missing_requires_csv_and_column(tmp_path):
    for mod in PKGS.values():
        with pytest.raises(FileNotFoundError):
            mod.scan_missing(str(tmp_path / "nowhere"))
    root = str(tmp_path / "badcols")
    _make_mirror(root, ["r/1_hr"], column="other")
    for mod in PKGS.values():
        with pytest.raises(KeyError, match="filename_hr"):
            mod.scan_missing(root)


def test_fetch_one_retries_then_succeeds(tmp_path):
    url = "https://example.org/r.dat"

    def call(mod, root, log):
        http = FakeHTTP({url: [urllib.error.HTTPError(url, 503, "busy", None, None),
                               ConnectionResetError("boom"), b"payload"]})
        ok = mod.fetch_one(url, os.path.join(root, "sub", "r.dat"), retries=3,
                           retry_wait=0.0, opener=http, log=log)
        return ok, http.calls

    (ok, calls), files, logs = _both(tmp_path, os.makedirs, call)
    assert ok and len(calls) == 3
    assert files == {"sub/r.dat": b"payload"}  # atomic rename, no .part left
    assert "server returned 503" in logs[1]


def test_fetch_one_gives_up_after_retries(tmp_path):
    url = "https://example.org/r.hea"

    def call(mod, root, log):
        http = FakeHTTP({url: [ConnectionResetError("x")] * 2})
        return mod.fetch_one(url, os.path.join(root, "r.hea"), retries=2, retry_wait=0.0,
                             opener=http, log=log)

    ok, files, logs = _both(tmp_path, os.makedirs, call)
    assert not ok and files == {}
    assert logs[-1].startswith("    giving up")


def test_fetch_missing_fills_only_absent_files(tmp_path):
    base = "https://mirror.test/ptbxl/"
    rels = ["records500/00000/00001_hr", "records500/00000/00002_hr"]

    def call(mod, root, log):
        http = FakeHTTP({base + rels[0] + ".hea": [b"h1"], base + rels[0] + ".dat": [b"d1"],
                         base + rels[1] + ".dat": [b"d2"]})
        report = mod.fetch_missing(root, base, opener=http, log=log)
        return vars(report), http.calls

    (report, calls), files, _ = _both(
        tmp_path, lambda r: _make_mirror(r, rels, [rels[1] + ".hea"]), call)
    assert report == {"missing": 2, "attempted": 2, "completed": 2, "failed_records": []}
    assert base + rels[1] + ".hea" not in calls  # the present .hea is not fetched again
    assert files[rels[1] + ".dat"] == b"d2"


def test_fetch_missing_caps_and_reports_failures(tmp_path):
    base = "https://mirror.test/ptbxl/"
    rels = [f"records500/00000/0000{i}_hr" for i in (1, 2, 3)]

    def call(mod, root, log):
        http = FakeHTTP({base + rels[0] + ".hea": [b"h"],
                         base + rels[0] + ".dat": [ConnectionResetError("x")] * 3,
                         base + rels[1] + ".hea": [b"h"], base + rels[1] + ".dat": [b"d"]})
        report = mod.fetch_missing(root, base, max_missing=2, retries=3, retry_wait=0.0,
                                   opener=http, log=log)
        return vars(report)

    report, _, _ = _both(tmp_path, lambda r: _make_mirror(r, rels), call)
    assert (report["missing"], report["attempted"], report["completed"]) == (3, 2, 1)
    assert report["failed_records"] == [rels[0]]


def test_fetch_missing_noop_on_complete_mirror(tmp_path):
    def call(mod, root, log):
        http = FakeHTTP({})
        return vars(mod.fetch_missing(root, opener=http, log=log)), http.calls

    (report, calls), _, logs = _both(
        tmp_path, lambda r: _make_mirror(r, ["r/1_hr"], ["r/1_hr.hea", "r/1_hr.dat"]), call)
    assert (report["missing"], report["attempted"], calls) == (0, 0, [])
    assert logs[-1] == "Mirror is complete; nothing to fetch."


def test_cli_exit_codes(tmp_path, monkeypatch):
    """0 when every record completes (``--max_missing`` caps the run), 1 when one
    stays incomplete."""
    base = "https://mirror.test/ptbxl/"
    rels = ["r/1_hr", "r/2_hr"]
    root = str(tmp_path / "m")
    _make_mirror(root, rels)
    http = FakeHTTP({base + "r/1_hr.hea": [b"h"], base + "r/1_hr.dat": [b"d"],
                     base + "r/2_hr.hea": [b"h"],
                     base + "r/2_hr.dat": [ConnectionResetError("x")] * 3})
    monkeypatch.setattr(cli01, "fetch_missing", functools.partial(
        fetch.fetch_missing, opener=http, retry_wait=0.0, log=lambda _: None))
    report = cli01.main(["--base_dir", root, "--base_url", base, "--max_missing", "1"])
    assert (report.missing, report.attempted, report.completed) == (2, 1, 1)
    with pytest.raises(SystemExit) as exc:
        cli01.main(["--base_dir", root, "--base_url", base])
    assert exc.value.code == 1
    assert not os.path.exists(os.path.join(root, "r/2_hr.dat.part"))


class _QuietHandler(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


def test_cli_over_loopback_http(tmp_path, capsys):
    """The real ``urllib`` opener against ``http.server`` on 127.0.0.1: the
    fetched files are the served bytes."""
    served = tmp_path / "served"
    rels = ["records500/00000/00001_hr", "records500/00000/00002_hr"]
    _make_mirror(str(served), rels)
    for rel in rels:
        (served / rel).parent.mkdir(parents=True, exist_ok=True)
        for sfx, payload in ((".hea", b"header " + rel.encode()), (".dat", os.urandom(64))):
            (served / (rel + sfx)).write_bytes(payload)
    local = tmp_path / "local"
    shutil.copytree(served, local)
    os.remove(local / (rels[0] + ".dat"))
    os.remove(local / (rels[1] + ".hea"))
    handler = functools.partial(_QuietHandler, directory=str(served))
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        report = cli01.main(["--base_dir", str(local),
                             "--base_url", f"http://127.0.0.1:{server.server_port}/"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    assert (report.missing, report.completed) == (2, 2)
    assert _tree(str(local)) == _tree(str(served))
    assert "Done: 2/2 record(s) completed." in capsys.readouterr().out
