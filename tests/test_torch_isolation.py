"""The port stands alone: no ``jax``, nothing of ``variantcalling_tpu``; no silent CPU.

- an AST scan of ``variantcalling_tpu_torch/`` and ``chip_smoke.py`` finds
  no import of either, nor of pandas or h5py, which the card's machine does
  not have (the registry's pickle name mapping is a string);
- a subprocess run of the port's CLI with ``--backend cpu`` ends with none
  of those packages in ``sys.modules``;
- without a CUDA device and without ``--backend cpu`` the CLI exits 2
  with a message and writes nothing, and the API raises;
- the native host engine (``variantcalling_tpu_torch/native/``) names no
  path of ``variantcalling_tpu/`` in any source, and its build command reads
  files of the port only.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "variantcalling_tpu", "pandas", "h5py")


def _port_sources() -> list[Path]:
    files = sorted((ROOT / "variantcalling_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names = [node.args[0].value]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_the_streaming_modules_are_scanned():
    """The streaming executor's modules are among the sources the scan above reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"variantcalling_tpu_torch/{m}.py" for m in (
        "utils/faults", "utils/degrade", "parallel/pipeline", "io/identity", "io/journal", "io/chunk_cache",
        "io/bgzf", "io/vcf", "pipelines/filter_variants")} <= scanned


def _run_cli(args: list[str], tmp_path: Path) -> subprocess.CompletedProcess:
    code = (
        "import json, sys\n"
        "from variantcalling_tpu_torch.__main__ import main\n"
        "rc = main(sys.argv[1:])\n"
        "print(json.dumps({'rc': rc, 'loaded': sorted(m for m in sys.modules "
        f"if m.split('.')[0] in {FORBIDDEN!r})}}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                          cwd=tmp_path, env=env, timeout=300)


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    from variantcalling_tpu_torch import synthetic

    d = tmp_path_factory.mktemp("iso")
    return synthetic.write_world(str(d), seed=1, length=30_000, n_variants=300, n_trees=4)


def _argv(w: dict, out: Path) -> list[str]:
    return ["filter_variants_pipeline", "--input_file", w["vcf"], "--model_file", w["model"],
            "--model_name", w["model_name"], "--reference_file", w["fasta"], "--output_file", str(out)]


def test_cli_cpu_run_loads_neither_jax_nor_reference(small_world, tmp_path):
    out = tmp_path / "out.vcf"
    proc = _run_cli([*_argv(small_world, out), "--backend", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"rc": 0, "loaded": []}
    text = out.read_text()
    assert "##vctpu_engine=torch-cpu" in text and "TREE_SCORE=" in text


def test_cli_without_cuda_exits_2_and_never_falls_back(small_world, tmp_path):
    out = tmp_path / "out.vcf"
    proc = _run_cli(_argv(small_world, out), tmp_path)
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["rc"] == 2
    assert "no CUDA device" in proc.stderr
    assert not out.exists()


def test_api_defaults_to_the_card_and_never_falls_back(small_world, monkeypatch):
    """``materialize_features`` without a device asks for the card: on a host
    without one it raises instead of running on the CPU."""
    import torch

    from variantcalling_tpu_torch import device, featurize
    from variantcalling_tpu_torch.io.fasta import FastaReader
    from variantcalling_tpu_torch.io.vcf import read_vcf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hf = featurize.host_featurize(read_vcf(small_world["vcf"]), FastaReader(small_world["fasta"]))
    with pytest.raises(device.DeviceUnavailable):
        featurize.materialize_features(hf)
    assert featurize.materialize_features(hf, device="cpu").matrix().shape == (300, len(hf.names))


NATIVE = ROOT / "variantcalling_tpu_torch" / "native"


@pytest.mark.parametrize("path", sorted(p for p in NATIVE.rglob("*") if p.is_file() and "__pycache__" not in p.parts),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_native_sources_name_no_reference_path(path):
    text = path.read_text()
    assert "variantcalling_tpu/" not in text and "variantcalling_tpu." not in text
    assert "variantcalling_tpu\\" not in text


def test_native_build_reads_only_files_of_the_port(tmp_path):
    """Every file the g++ command names lies in the port's ``native/src``
    (or is the output); the sources it includes lie there too."""
    from variantcalling_tpu_torch import native

    out = tmp_path / "lib.so"
    cmd = native.build_command(out)
    files = [Path(a) for a in cmd[1:] if a.endswith((".cc", ".h", ".cpp"))]
    assert files and all(f.resolve().parent == NATIVE / "src" for f in files)
    assert all(not a.startswith(("-I", "-L", "-include")) for a in cmd), cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    for src in (NATIVE / "src").iterdir():
        for line in src.read_text().splitlines():
            if line.startswith("#include \""):
                assert (NATIVE / "src" / line.split('"')[1]).exists(), line
