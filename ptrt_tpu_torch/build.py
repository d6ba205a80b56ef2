"""Where the port's native libraries build, and how.

Both libraries — the host BVH builder (``native/``) and the CUDA kernels
(``csrc/``) — are compiled at first use into ``BUILD_DIR``, a git-ignored
directory of the checkout, and loaded with ``ctypes``.  A library is rebuilt
when a source is newer than it.  A build writes a private temporary file and
renames it into place, so concurrent processes never load a half-written
library.  A failed build raises with the compiler's output: there is no
fallback.
"""

from __future__ import annotations

import os
import subprocess
import threading

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "ptrt_tpu_torch")
# the JAX package's directory: the port reads two files there by path
REFERENCE_DIR = os.path.join(REPO_ROOT, "ptrt_tpu")

_lock = threading.Lock()


class BuildError(RuntimeError):
    pass


def _stale(out: str, sources: list[str]) -> bool:
    if not os.path.exists(out):
        return True
    t = os.path.getmtime(out)
    return any(os.path.getmtime(s) > t for s in sources)


def build_shared_library(name: str, sources: list[str],
                         command: list[str], timeout: int = 900) -> str:
    """Compile ``sources`` into ``BUILD_DIR/name`` unless it is up to date.

    ``command`` is the compiler invocation without its output argument;
    ``-o <tmp>`` is appended.  Returns the library's path."""
    out = os.path.join(BUILD_DIR, name)
    with _lock:
        if not _stale(out, sources):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(command + ["-o", tmp], capture_output=True,
                                  text=True, timeout=timeout)
        except FileNotFoundError as e:
            raise BuildError(f"compiler not found: {command[0]}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise BuildError(
                f"building {name} failed ({' '.join(command)}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out
