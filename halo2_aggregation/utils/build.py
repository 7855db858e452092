"""Build the repository's native libraries from their tracked sources.

Each library is compiled into ``build/`` (listed in .gitignore), under a
file name keyed by the SHA-256 of its source and its compiler command,
so an edited source or a changed flag always rebuilds, and an unchanged
one is never rebuilt.  A failed build raises with the compiler's
message: there is no fallback.

    python -m halo2_aggregation.utils.build    # build everything now

builds the C++ host engine here, and the CUDA ladder too where ``nvcc``
is found.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess

from ..platform import BUILD_DIR, REPO_ROOT

NATIVE_DIR = os.path.join(REPO_ROOT, "native")


def source_path(name: str) -> str:
    return os.path.join(NATIVE_DIR, name)


def library_path(src: str, cmd: list, stem: str) -> str:
    """build/<stem>-<hash>.so for this source and compiler command."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update("\0".join(cmd).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build_shared_library(src: str, cmd: list, stem: str) -> str:
    """Compile `src` with `cmd + ["-o", out, src]` unless the keyed
    output already exists; returns the library's path.

    Concurrent processes (test workers) serialize on a lock file, so one
    builds and the rest load its output.  The compiler writes a temporary
    file that is renamed into place, so a process that already mapped an
    older build is never disturbed."""
    out = library_path(src, cmd, stem)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.build.{os.getpid()}"
        proc = subprocess.run(
            [*cmd, "-o", tmp, src], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {os.path.basename(src)} failed "
                f"({' '.join(cmd)}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, out)
    return out


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin, PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


if __name__ == "__main__":
    from . import native
    from ..ops import ec_ladder

    print(native.library_file())
    print(ec_ladder.host_library_file())
    try:
        nvcc = find_nvcc()
    except RuntimeError as e:
        print(f"CUDA ladder not built: {e}")
    else:
        print(ec_ladder.cuda_library_file(nvcc))
