"""Backend selection and the on-disk caches' home.

The reference tries discrete GPU -> UMA -> WARP software rasterizer at device
creation (DXRVoxelizer.cpp:89-128, 590-636). Here the accelerator is the
default and the CPU runs only when asked for (``-warp``/``-cpu``, or
``JAX_PLATFORMS=cpu``): a missing accelerator is an error, never a silent
CPU fallback.
"""

from __future__ import annotations

import os
import sys

# fixed home of every on-disk cache (compile cache, ray tables, accels):
# inside the checkout, listed in .gitignore
CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache",
)


def _host_cache_key() -> str:
    """Cache subdirectory keyed on the host CPU's ISA feature set.

    CPU AOT artifacts compiled on one host can use vector extensions a
    different host lacks — XLA warns the mismatch "could lead to execution
    errors such as SIGILL" when loading them. Keying the directory on the
    cpuinfo flags makes hosts with differing features never share entries.
    """
    import hashlib
    import platform as _plat

    sig = _plat.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    sig += line
                    break
    except OSError:
        sig += _plat.processor()
    return hashlib.sha1(sig.encode()).hexdigest()[:10]


_FILTERING = False


def filter_benign_aot_noise() -> None:
    """Drop XLA's known-benign CPU AOT feature-mismatch log from stderr.

    The persistent compile cache is keyed per host ISA (_host_cache_key),
    which removes the real SIGILL hazard; the remaining cpu_aot_loader
    complaint fires on the ``+prefer-no-gather`` / ``+prefer-no-scatter``
    LLVM *tuning* flags the compile side records but host detection never
    reports — same-host artifacts trigger it too, and avoiding gathers
    cannot raise SIGILL. It is multi-KB of noise per process, so swallow
    exactly that message and pass everything else through.
    """
    import threading

    global _FILTERING
    if _FILTERING:  # one pump per process (the app may run many times)
        return
    _FILTERING = True
    real = os.dup(2)
    r, w = os.pipe()
    os.dup2(w, 2)
    os.close(w)

    def drop(line: bytes) -> bool:
        return (b"cpu_aot_loader" in line
                or b"Machine type used for XLA:CPU compilation" in line)

    def pump():
        # os.read, not file iteration: `for line in f` readahead-buffers
        # up to 8 KB, trapping progress lines for minutes (and losing them
        # outright when the daemon thread dies at interpreter exit).
        # Forward every complete line as soon as it arrives; only a
        # trailing partial line is held back.
        part = b""
        while True:
            chunk = os.read(r, 65536)
            if not chunk:
                if part and not drop(part):
                    os.write(real, part)
                os.close(r)
                return
            part += chunk
            lines = part.split(b"\n")
            part = lines.pop()
            for line in lines:
                if not drop(line):
                    os.write(real, line + b"\n")

    t = threading.Thread(target=pump, daemon=True)
    t.start()

    def restore():
        # Point fd 2 back at the terminal and close the pipe's write end:
        # the pump sees EOF, flushes any held partial line, and exits
        # before the interpreter kills daemon threads.
        try:
            sys.stderr.flush()
        except Exception:
            pass
        os.dup2(real, 2)
        t.join(timeout=2.0)

    import atexit

    atexit.register(restore)


def enable_compile_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps the cache there
    on its own and nothing is set here. Otherwise the cache lives at a
    fixed directory inside the checkout (the precompiled-shader analog:
    the reference ships .cso blobs, SURVEY.md section 2b); CPU executables
    go to a per-host-ISA subdirectory (_host_cache_key). Call after
    :func:`select_backend` and before the first compile.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    from dxrvoxelizer_tpu.ops import route

    cache_dir = os.path.join(CACHE_ROOT, "xla")
    if route.platform() == "cpu":
        cache_dir = os.path.join(cache_dir, "cpu-" + _host_cache_key())
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


def select_backend(prefer: str = "default") -> str:
    """Activate a backend; returns the platform name in use.

    ``prefer="cpu"`` selects the CPU (the reference's -warp). Otherwise the
    default backend must be an accelerator, unless the CPU was chosen
    explicitly through the ``jax_platforms`` setting (``JAX_PLATFORMS=cpu``)
    — finding no accelerator raises instead of falling back.
    """
    import jax

    if prefer == "cpu":
        jax.config.update("jax_platforms", "cpu")
        return "cpu"
    platform = jax.devices()[0].platform
    if platform == "cpu" and (jax.config.jax_platforms or "") != "cpu":
        raise RuntimeError(
            "dxrvoxelizer_tpu: no accelerator found; run with -warp (or "
            "JAX_PLATFORMS=cpu) to use the CPU"
        )
    return platform
