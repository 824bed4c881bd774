"""Build-at-first-use for the package's shared libraries.

Each library is compiled into `<checkout>/build/<name>-<hash>/`, where the
hash covers the sources and the compile command, so an edited source gets a
fresh build and an unchanged one is reused. A file lock serialises
concurrent builds (several test worker processes importing at once), and
the library is written under a temporary name and renamed into place, so no
process ever loads a half-written file.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")


def build_shared(name: str, srcs: list[str], command, timeout: float = 600):
    """Compile `srcs` into a shared library and return its path.

    command: callable(out_path) -> argv that writes the library to
    out_path. The compiler's output is kept in `build.log` beside the
    library. Raises subprocess.CalledProcessError (with the compiler's
    output attached) when the build fails.
    """
    digest = hashlib.sha256()
    for src in srcs:
        with open(src, "rb") as f:
            digest.update(f.read())
    digest.update("\0".join(command("OUT")).encode())
    out_dir = os.path.join(BUILD_ROOT, f"{name}-{digest.hexdigest()[:16]}")
    lib = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(lib):
                tmp = f"{lib}.tmp{os.getpid()}"
                res = subprocess.run(command(tmp), capture_output=True,
                                     text=True, timeout=timeout)
                with open(os.path.join(out_dir, "build.log"), "w") as log:
                    log.write(res.stdout + res.stderr)
                if res.returncode != 0:
                    raise subprocess.CalledProcessError(
                        res.returncode, res.args, res.stdout, res.stderr)
                os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def build_log(lib: str) -> str:
    """The compiler output saved beside a library built here."""
    path = os.path.join(os.path.dirname(lib), "build.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
