"""PyTorch port, module coverage: every `.py` module of the JAX package has
a module of the same path in open_pandora_tpu_torch/, or stands on the
list below with the reason it is left out or where its port lives."""

from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "open_pandora_tpu"
PORT_PKG = REPO / "open_pandora_tpu_torch"

ACCOUNTED = {
    "core/cache.py": "the XLA persistent compilation cache; PyTorch "
                     "compiles no program graph the port runs",
    "utils/xplane.py": "a parser of XLA's XSpace traces; the port reads "
                       "torch.profiler's (utils/profiling.py)",
    "tools/preflight.py": "the census of Mosaic ahead-of-time compiles "
                          "for the TPU",
    "tools/conv_bench.py": "a microbenchmark of the TPU's conv routes; "
                           "chip_smoke.py phase 3 times the port's",
    "native/__init__.py": "ported as native.py (the preprocessing "
                          "loader of native/preproc.cpp)",
}


def test_every_jax_module_has_a_port():
    jax_modules = sorted(str(p.relative_to(JAX_PKG))
                         for p in JAX_PKG.rglob("*.py"))
    missing = [m for m in jax_modules if m not in ACCOUNTED
               and not (PORT_PKG / m).is_file()]
    assert not missing, missing


def test_the_list_is_current():
    """Each listed module exists in the JAX package and has no port of the
    same path (a listed module that gets one comes off the list); the
    native loader's port exists where the list says."""
    for m in ACCOUNTED:
        assert (JAX_PKG / m).is_file(), m
        assert not (PORT_PKG / m).is_file(), m
    assert (PORT_PKG / "native.py").is_file()
