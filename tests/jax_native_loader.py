"""The JAX package's C++ I/O library, loaded for the byte-equality tests in a
way that test processes running side by side cannot break.

``ccvm_tpu.native._load_library`` builds with g++ straight into
``ccvm_tpu/native/libccvm_io.so`` (no temp file) and, once a build or load
has failed, returns None for the rest of the process.  Every JAX test that
parses an instance calls it, so in a checkout without the library several
workers may link that file at once, and one of them may open another's
half-written output.  :func:`jax_native_library` instead points the loader
at a library of its own under the checkout's ``build/jax_native/``, clears
the remembered failure and loads it while holding a file lock, so one
process builds it and the others open the finished file.  Nothing in
``ccvm_tpu`` is edited: the loader is the JAX package's own, only its
module globals are set.
"""

from __future__ import annotations

import fcntl
import os

import ccvm_tpu.native as jnative

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "build", "jax_native")
_LIB_PATH = os.path.join(_DIR, "libccvm_io.so")


def jax_native_library():
    """The JAX package's C++ library as its module holds it (``_lib``),
    built into ``build/jax_native/`` under a lock once a process; None if
    g++ cannot build it."""
    if jnative._LIB_PATH == _LIB_PATH and jnative._lib is not None:
        return jnative._lib
    os.makedirs(_DIR, exist_ok=True)
    with open(os.path.join(_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        jnative._LIB_PATH = _LIB_PATH
        jnative._lib = None
        jnative._build_attempted = False
        return jnative._load_library()
