"""Nothing the benchmark loads is JAX or the JAX package, and the reference loads nothing
of the port (fresh interpreters; top-level module names compared whole)."""
import subprocess
import sys

from portbench import catalog

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _loaded(code: str) -> set[str]:
    """Top-level names of the modules loaded by ``code`` in a fresh interpreter."""
    paths = [str(catalog.ROOT / "src"), str(catalog.ROOT)]
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = {paths!r}\n{code}\n"
         "print('\\n'.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=300, check=True, cwd=catalog.ROOT)
    return set(out.stdout.split())


def test_harness_and_port_load_no_jax():
    loaded = _loaded(
        "import importlib\n"
        "for m in ('bench', 'catalog', 'data', 'judge', 'readings', 'reference', 'run',\n"
        "          'spans', 'system', 'traffic', 'work'):\n"
        "    importlib.import_module('portbench.' + m)\n"
        "import repro_torch.serving, repro_torch.core.executor, repro_torch.data.synthetic\n"
        "from portbench import catalog\n"
        "for m in catalog.benchmark()['end_to_end'] + catalog.benchmark()['per_layer']:\n"
        "    catalog.metric_reader(m['name'])")
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded("import portbench.reference, portbench.data, portbench.judge")
    assert "repro_torch" not in loaded and not loaded & set(FORBIDDEN)
