"""Compile the port's shared libraries into place, for ``ctypes``.

The CUDA kernels (``ops/build.py``, ``nvcc``) and the host I/O library
(``native``, ``g++``) are built at first use into ``build/`` at the root of
the checkout, each library named by a hash of its sources.  Each compiler
writes a file of its own, which is then renamed into place, so processes
that build the same library at once each load a whole file.  A failure
raises ``RuntimeError`` with the compiler's command and output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading


def digest(paths) -> str:
    """The first 12 hex digits of the SHA-1 of each file's name and bytes,
    in order: the name part of a library built from them."""
    h = hashlib.sha1()
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:12]


def compile_into(jobs, what: str) -> dict:
    """Run every ``(out, command)`` of ``jobs`` at once, ``command(tmp)``
    being the compiler line that writes the library to ``tmp``, and rename
    each output to its ``out``.  Returns ``{out: the compiler's output}``;
    raises naming ``what`` if a compiler is missing or fails (a failed
    build leaves no file behind)."""
    procs = []
    for out, command in jobs:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = command(tmp)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:  # no such compiler
            for *_, started in procs:
                started.kill()
                started.communicate()
            raise RuntimeError(f"cannot build {what}: {' '.join(cmd)}: {e}") from e
        procs.append((out, tmp, cmd, proc))
    logs, failures = {}, []
    for out, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            failures.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        logs[out] = log
    if failures:
        raise RuntimeError(f"building {what} failed:\n" + "\n".join(failures))
    return logs
