"""Build the repository's native C++ libraries on first use.

The port loads ``native/``'s libraries (the same C++ sources the reference
package builds) through ctypes; :func:`ensure_native_lib` runs
``make -C native <lib>`` when the library is missing or older than its
sources.
"""

from __future__ import annotations

import logging
import os
import subprocess

__all__ = ["REPO_ROOT", "ensure_native_lib"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

log = logging.getLogger("tpunode_torch.native")


def ensure_native_lib(lib_path: str, src_subdir: str) -> str:
    """Build ``lib_path`` with make when missing or older than its sources.

    If a rebuild fails but a prebuilt library exists, it is loaded with a
    warning: a fresh checkout gives every source a newer mtime than a
    current prebuilt library, and a host without a toolchain must still
    run.  A missing library whose build fails raises."""
    native_dir = os.path.join(REPO_ROOT, "native")
    srcs = [os.path.join(native_dir, "Makefile")]
    src_dir = os.path.join(native_dir, src_subdir)
    if os.path.isdir(src_dir):
        srcs += [
            os.path.join(src_dir, f)
            for f in os.listdir(src_dir)
            if f.endswith((".cpp", ".h", ".hpp"))
        ]
    stale = not os.path.exists(lib_path) or any(
        os.path.getmtime(s) > os.path.getmtime(lib_path)
        for s in srcs
        if os.path.exists(s)
    )
    if stale:
        try:
            subprocess.run(
                ["make", "-C", native_dir,
                 os.path.join("build", os.path.basename(lib_path))],
                check=True,
                capture_output=True,
            )
        except (OSError, subprocess.CalledProcessError):
            if not os.path.exists(lib_path):
                raise
            log.warning(
                "rebuild of %s failed but a prebuilt library exists; "
                "loading it", os.path.basename(lib_path),
            )
    return lib_path
