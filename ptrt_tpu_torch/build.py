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
import shutil
import subprocess
import tempfile
import threading

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "ptrt_tpu_torch")

_lock = threading.Lock()


class BuildError(RuntimeError):
    pass


def _stale(out: str, sources: list[str]) -> bool:
    if not os.path.exists(out):
        return True
    t = os.path.getmtime(out)
    return any(os.path.getmtime(s) > t for s in sources)


def _start(command: list[str]) -> subprocess.Popen:
    try:
        return subprocess.Popen(command, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    except FileNotFoundError as e:
        raise BuildError(f"compiler not found: {command[0]}") from e


def _finish(proc: subprocess.Popen, what: str, timeout: int) -> None:
    """Wait for a compiler process; raise with its output if it failed."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise BuildError(f"{what} timed out after {timeout} s") from None
    if proc.returncode != 0:
        raise BuildError(f"{what} failed ({' '.join(proc.args)}):\n"
                         f"{stdout}{stderr}")


def _link(name: str, command: list[str], timeout: int) -> str:
    """Run ``command -o <tmp>`` and rename the result into place."""
    out = os.path.join(BUILD_DIR, name)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        _finish(_start(command + ["-o", tmp]), f"building {name}", timeout)
    except BuildError:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    os.replace(tmp, out)
    return out


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
        return _link(name, command, timeout)


def build_linked_library(name: str, compile_commands: dict[str, list[str]],
                         link_command: list[str], timeout: int = 900) -> str:
    """Compile each source with its own command (``-o <object>`` appended),
    all compilers started together, then link the objects into
    ``BUILD_DIR/name`` with ``link_command`` (objects and ``-o <tmp>``
    appended), unless the library is up to date.  Returns its path."""
    out = os.path.join(BUILD_DIR, name)
    with _lock:
        if not _stale(out, list(compile_commands)):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        objdir = tempfile.mkdtemp(prefix=f"{name}.obj.", dir=BUILD_DIR)
        procs = []
        try:
            objects = []
            for src, command in compile_commands.items():
                obj = os.path.join(objdir, os.path.basename(src) + ".o")
                objects.append(obj)
                procs.append((src, _start(command + ["-o", obj])))
            for src, proc in procs:
                _finish(proc, f"compiling {os.path.basename(src)}", timeout)
            return _link(name, link_command + objects, timeout)
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            shutil.rmtree(objdir, ignore_errors=True)
