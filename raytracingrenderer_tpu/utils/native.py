"""Build the native libraries under `native/` at first use.

The sources are committed; the libraries are not.  `make` rebuilds a
library only when its source is newer, under a file lock so that
concurrent processes (test workers, several ranks) never race on one
output file.
"""
from __future__ import annotations

import fcntl
import os
import subprocess

NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                          "..", "native"))


def build(target: str, **make_vars: str) -> str:
    """`make -C native <target>`; returns the library's absolute path.

    Raises RuntimeError carrying the compiler's output if the build
    fails."""
    os.makedirs(os.path.join(NATIVE_DIR, "build"), exist_ok=True)
    cmd = (["make", "-s", "-C", NATIVE_DIR, target]
           + [f"{k}={v}" for k, v in make_vars.items()])
    with open(os.path.join(NATIVE_DIR, "build", ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    return os.path.join(NATIVE_DIR, target)
