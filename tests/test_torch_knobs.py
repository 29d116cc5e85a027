"""The port's knob registry against the JAX package's.

Field for field the same registry; the same parse of each kind (and the same
messages); ``validate_all`` refusing a malformed value of any knob, also of
one the port does not read, so that both CLIs exit 2 on it before they read
their input; the two knobs the port reads keep their messages; unknown
``VCTPU_*`` names draw a warning with the closest registered name; the
``knobs`` tool prints the reference's dump, as text and as ``--json``.
"""

import dataclasses
import logging

import pytest

from variantcalling_tpu import knobs as jknobs
from variantcalling_tpu.engine import EngineError as JEngineError
from variantcalling_tpu.pipelines import filter_variants as fvp
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch import synthetic as tsynth
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.engine import EngineError


def test_registry_equals_the_reference_field_for_field():
    assert list(knobs.REGISTRY) == list(jknobs.REGISTRY)
    for name, knob in knobs.REGISTRY.items():
        assert dataclasses.asdict(knob) == dataclasses.asdict(jknobs.REGISTRY[name]), name


def _parse(mod, err, name: str, value: str):
    try:
        return "ok", mod._parse(mod.REGISTRY[name], value)
    except err as e:
        return "error", str(e)


@pytest.mark.parametrize("name,value", [
    ("VCTPU_GENOME_CACHE", "0"), ("VCTPU_GENOME_CACHE", " Yes "), ("VCTPU_GENOME_CACHE", "maybe"),
    ("VCTPU_GENOME_CACHE", ""), ("VCTPU_FASTA_CACHE_BYTES", "-1"), ("VCTPU_FASTA_CACHE_BYTES", "12"),
    ("VCTPU_FASTA_CACHE_BYTES", "1e9"), ("VCTPU_THREADS", "0"), ("VCTPU_THREADS", "x"),
    ("VCTPU_STAGE_TIMEOUT_S", "-0.5"), ("VCTPU_STAGE_TIMEOUT_S", "2.5"), ("VCTPU_STAGE_TIMEOUT_S", "soon"),
    ("VCTPU_FOREST_STRATEGY", "WIDE"), ("VCTPU_FOREST_STRATEGY", "fastest"), ("VCTPU_MODEL_FAMILY", "threshold"),
    ("VCTPU_GENOME_CACHE_DIR", ""), ("VCTPU_GENOME_CACHE_DIR", " /tmp/x "), ("VCTPU_RESUME_VERIFY", "Full"),
])
def test_parse_and_messages_equal_the_reference(name, value):
    assert _parse(knobs, EngineError, name, value) == _parse(jknobs, JEngineError, name, value)


def test_typed_getters_and_validate_all(monkeypatch):
    monkeypatch.setenv("VCTPU_FASTA_CACHE_BYTES", "1024")
    monkeypatch.setenv("VCTPU_GENOME_CACHE", "off")
    assert knobs.get_int("VCTPU_FASTA_CACHE_BYTES") == 1024 and knobs.get_bool("VCTPU_GENOME_CACHE") is False
    assert knobs.raw("VCTPU_GENOME_CACHE") == "off" and knobs.get("VCTPU_THREADS") is None
    with pytest.raises(TypeError):
        knobs.get_bool("VCTPU_FASTA_CACHE_BYTES")
    with pytest.raises(KeyError):
        knobs.get("VCTPU_NOT_A_KNOB")
    knobs.validate_all()
    monkeypatch.setenv("VCTPU_IO_RETRIES", "-3")
    with pytest.raises(EngineError, match="VCTPU_IO_RETRIES='-3' must be >= 0"):
        knobs.validate_all()


def test_unknown_names_draw_a_warning(monkeypatch, caplog):
    monkeypatch.setenv("VCTPU_FOERST_STRATEGY", "wide")
    caplog.set_level(logging.WARNING)
    assert knobs.warn_unknown_env() == jknobs.warn_unknown_env() == [
        "unknown environment variable VCTPU_FOERST_STRATEGY is ignored — did you mean VCTPU_FOREST_STRATEGY?"]


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("knobs")
    w = tsynth.write_world(str(d), seed=3, length=30_000, n_variants=200, n_trees=3)
    return ["--input_file", w["vcf"], "--model_file", w["model"], "--model_name", w["model_name"],
            "--reference_file", w["fasta"], "--backend", "cpu"]


@pytest.mark.parametrize("name,value", [
    ("VCTPU_FASTA_CACHE_BYTES", "-1"), ("VCTPU_GENOME_CACHE", "maybe"), ("VCTPU_THREADS", "many"),
    ("VCTPU_SERVE_PORT", "-2"), ("VCTPU_FOREST_STRATEGY", "fastest"),
])
def test_malformed_knob_exits_2_from_both_clis_before_ingest(small_world, monkeypatch, tmp_path, caplog, name,
                                                             value):
    """The input is missing as well: a CLI that read anything before checking
    the knobs would fail on it with another error."""
    argv = list(small_world)
    argv[argv.index("--input_file") + 1] = str(tmp_path / "absent.vcf")
    monkeypatch.setenv(name, value)
    caplog.set_level(logging.ERROR)
    assert fvp.run([*argv, "--output_file", str(tmp_path / "ref.vcf")]) == 2
    assert torch_main(["filter_variants_pipeline", *argv, "--output_file", str(tmp_path / "port.vcf")]) == 2
    assert not (tmp_path / "ref.vcf").exists() and not (tmp_path / "port.vcf").exists()
    messages = [r.getMessage() for r in caplog.records if name in r.getMessage()]
    assert len(messages) == 2 and messages[0] == messages[1], messages


def test_honoured_knobs_are_the_ones_the_port_reads():
    """Every knob name the port's Python spells (as a whole string literal,
    outside the registry) is marked honoured, and every honoured knob is
    read, the native engine's thread cap by its C++."""
    import ast
    import re
    from pathlib import Path

    root = Path(knobs.__file__).resolve().parent
    read = set()
    for path in root.rglob("*.py"):
        if path == Path(knobs.__file__).resolve():
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and re.fullmatch(r"VCTPU_[A-Z_]+", node.value):
                read.add(node.value)
    assert "VCTPU_NATIVE_THREADS" in (root / "native" / "src" / "vctpu_threads.h").read_text()
    assert read | {"VCTPU_NATIVE_THREADS"} == knobs.HONOURED and knobs.HONOURED <= set(knobs.REGISTRY)


#: the telemetry's knobs, which the port reads since its telemetry slice
OBS_KNOBS = {"VCTPU_OBS", "VCTPU_OBS_PATH", "VCTPU_OBS_WINDOW_S", "VCTPU_OBS_PROFILE", "VCTPU_OBS_SAMPLE_S",
             "VCTPU_OBS_CPUPROF", "VCTPU_OBS_CPUPROF_HZ", "VCTPU_OBS_TAIL_POLL_S", "VCTPU_OBS_JAXPROF",
             "VCTPU_OBS_TRACE", "VCTPU_OBS_SNAPSHOT_S", "VCTPU_OBS_MAX_MB", "VCTPU_OBS_PROM_FILE", "VCTPU_TRACE"}


def test_the_obs_knobs_are_honoured():
    assert OBS_KNOBS <= knobs.HONOURED and {k for k in knobs.REGISTRY if k.startswith("VCTPU_OBS")} <= OBS_KNOBS


@pytest.mark.parametrize("env", [{}, {"VCTPU_IO_THREADS": "3", "VCTPU_OBS": "1", "VCTPU_OBS_CPUPROF_HZ": "19"},
                                 {"VCTPU_FOERST_STRATEGY": "wide"}], ids=["defaults", "set", "misspelt"])
@pytest.mark.parametrize("json_out", [True, False], ids=["json", "text"])
def test_knobs_tool_prints_the_references_dump(monkeypatch, capsys, env, json_out):
    for k in [k for k in __import__("os").environ if k.startswith("VCTPU_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = ["--json"] if json_out else []
    assert jknobs.run(list(argv)) == 0
    want = capsys.readouterr().out
    assert torch_main(["knobs", *argv]) == 0
    got = capsys.readouterr().out
    assert got == want
    if json_out and not env.get("VCTPU_FOERST_STRATEGY"):
        dump = __import__("json").loads(got)
        assert list(dump) == sorted(knobs.REGISTRY) and dump["VCTPU_OBS"]["source"] == ("env" if env else "default")


def test_knobs_tool_exits_2_on_a_malformed_value(monkeypatch, capsys):
    monkeypatch.setenv("VCTPU_OBS_MAX_MB", "-3")
    assert jknobs.run(["--json"]) == 2
    want = capsys.readouterr()
    assert torch_main(["knobs", "--json"]) == 2
    got = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err) and "VCTPU_OBS_MAX_MB" in got.err
