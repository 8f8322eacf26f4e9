"""The kernel build's log (``ops/_build.py``): with a stand-in ``nvcc`` (a
script that writes its output file after spending a known share of CPU),
``build`` starts one compiler per object of every source and part, links
them, and records each object's seconds to finish and its compiler tree's
CPU seconds, which ``object_times`` reads back; a failing compiler raises
with its output."""

import os
import stat
import sys

import pytest

from leaxer_qwen3_tts_torch.ops import _build

FAKE = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    if "{fail}" and args[-1].endswith("{fail}"):
        print("error: a fault in " + args[-1])
        sys.exit(2)
    t = time.process_time()
    while time.process_time() - t < 0.05:  # CPU the log must count
        pass
    print("ptxas info    : Used 32 registers")
with open(out, "wb") as f:
    f.write(b"obj")
"""


def _fake(tmp_path, monkeypatch, fail=""):
    nvcc = os.path.join(tmp_path, "nvcc")
    with open(nvcc, "w") as f:
        f.write(FAKE.format(python=sys.executable, fail=fail))
    os.chmod(nvcc, os.stat(nvcc).st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", os.path.join(tmp_path, "build"))


def test_build_log_records_each_objects_cpu(tmp_path, monkeypatch):
    _fake(tmp_path, monkeypatch)
    path = _build.build()
    assert os.path.exists(path) and path == _build.library_path()
    times = _build.object_times(path + ".log")
    want = [obj + ".o" for _, obj, _ in _build.units()]
    assert [t[0] for t in times] == want
    for _, finish, cpu in times:
        assert finish >= 0.0 and cpu >= 0.04  # the stand-in's 0.05 s of CPU, at 0.1 s rounding
    assert _build.build() == path  # built once: the library is reused


def test_build_failure_raises_with_output(tmp_path, monkeypatch):
    _fake(tmp_path, monkeypatch, fail="flash_attention.cu")
    with pytest.raises(RuntimeError, match="a fault in .*flash_attention.cu"):
        _build.build()
