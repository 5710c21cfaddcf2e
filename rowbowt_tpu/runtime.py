"""Process start-up shared by every entry point: device check + compile cache.

Every CLI `main`, `scripts/sharded_stream.py`, the `bench.py` workers and
`chip_smoke.py` call `init()` before their first JAX computation.

- No hidden CPU: the query engines are written for an NVIDIA GPU.  If JAX's
  default backend is anything else, `init` raises, naming the backend it
  found.  The one exception is an explicit `JAX_PLATFORMS=cpu`, which is how
  the tests and deliberate CPU users ask for the CPU; measurement paths pass
  `allow_explicit_cpu=False` and never accept it.
- Compile cache, on the GPU: when `JAX_COMPILATION_CACHE_DIR` is set, JAX
  reads it itself and this module sets nothing; otherwise the cache lives at
  the fixed path `<checkout>/.cache/jax`, so that runs from one checkout
  share it.  CPU runs (the tests) keep no persistent cache: XLA:CPU entries
  written on one host can fault when loaded on another.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".cache", "jax")


class NoAcceleratorError(RuntimeError):
    """JAX found no GPU and the CPU was not asked for explicitly."""


def explicit_cpu() -> bool:
    return os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"


def require_gpu(allow_explicit_cpu: bool = True) -> str:
    """Return JAX's default backend; raise unless it is 'gpu' (or the CPU was
    requested with JAX_PLATFORMS=cpu and `allow_explicit_cpu`)."""
    import jax

    backend = jax.default_backend()
    if backend == "gpu" or (allow_explicit_cpu and backend == "cpu"
                            and explicit_cpu()):
        return backend
    hint = ("" if not allow_explicit_cpu else
            "; set JAX_PLATFORMS=cpu to run on the CPU on purpose")
    raise NoAcceleratorError(
        f"no NVIDIA GPU: JAX's default backend is {backend!r} "
        f"(devices: {jax.devices()}){hint}")


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; return it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def nvidia_smi() -> list[str]:
    """`name, power.limit` of each card, as nvidia-smi reports them (the
    limit bounds the clocks a card holds under load, so it goes beside
    every time)."""
    import subprocess

    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return [line for line in r.stdout.splitlines() if line.strip()]


def init(allow_explicit_cpu: bool = True) -> str:
    """Device check, then (on the GPU) the compile cache, which JAX opens at
    the first compilation.  Returns the backend name."""
    backend = require_gpu(allow_explicit_cpu)
    if backend == "gpu":
        setup_compile_cache()
    return backend
