"""The port's native-library loader under concurrency: several processes load
it at once on an empty build directory and every load succeeds.  Runs on a
private temporary build directory, never the shared one, and checks that the
JAX package's ``native/build/`` is not touched."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 6

_CHILD = (
    "import sys\n"
    "from leaxer_qwen3_tts_torch.frontend import native\n"
    "native.BUILD_DIR = sys.argv[1]\n"
    "lib = native.load_native()\n"
    "assert lib is not None, 'load failed'\n"
    "assert native.library_path().startswith(sys.argv[1]), native.library_path()\n"
    "assert lib.qtts_tok_create is not None\n"
    "print('ok')\n"
)


def _mtimes(path):
    if not os.path.isdir(path):
        return None
    return sorted((f, os.stat(os.path.join(path, f)).st_mtime_ns) for f in os.listdir(path))


@pytest.mark.skipif(shutil.which("make") is None or shutil.which("g++") is None,
                    reason="no C++ toolchain to build the native library")
def test_concurrent_loads_on_empty_build_dir(tmp_path):
    build_dir = str(tmp_path / "torch_native")
    jax_build = os.path.join(REPO, "native", "build")
    before = _mtimes(jax_build)
    env = {k: v for k, v in os.environ.items() if k != "QTTS_NO_AUTOBUILD"}
    procs = [
        subprocess.Popen([sys.executable, "-c", _CHILD, build_dir], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(N_PROCS)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "ok", err
    # one finished library, no temporary build directory left behind
    assert sorted(f for f in os.listdir(build_dir) if not f.startswith(".")) == ["libqtts.so"]
    assert _mtimes(jax_build) == before
