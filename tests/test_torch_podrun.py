"""The port's pod launcher (``python -m variantcalling_tpu_torch.parallel.podrun``)
in subprocesses, against the reference's ``tools/podrun``.

World: ``tests/torch_worlds.write_pod_world`` in 16 KiB chunks, workers on
the CPU (``--backend cpu``), two threads each.

- A classic 2-rank pod writes the reference launcher's merged bytes outside
  ``##vctpu_*`` (the ``##vctpu_ranks=n=2`` line in both) and leaves nothing
  beside the output.
- An elastic pod with a worker SIGKILLed after its first journaled chunk
  recovers in the same launch (``membership: recut`` or ``reassign``) to the
  port's single-rank bytes exactly, with nothing left over; its coordinator's
  obs stream holds the membership events.
- A classic pod whose worker is SIGKILLed exits 3 and leaves the destination
  untouched; the relaunch skips the finished rank and commits the bytes.
- Four workers starting together on a FASTA without its ``.venc`` sidecar
  each write and read a whole one.
- The chaos drills (``--elastic --chaos steal_race|join_during_merge``): the
  duplicate claimant is refused and the bytes are the single-rank run's.
- Distinct exits: a worker's configuration error gives the pod its code 2
  (``VCTPU_THREADS=1``; ``--backend gpu`` without a card); ``--chaos``
  without ``--elastic``, ``--fabric`` with forwarded arguments, no
  ``--output_file`` and ``--ranks 0`` exit 2.
- The serving fabric as processes (``start_fabric(..., backend="cpu")``): two
  backends and a router; a streamed ``.vcf.gz`` request gives the batch CLI's
  bytes, the router never maps torch, ``stop_fabric`` reports rc 0,
  ``drained`` and no leaked thread for each tier, each backend logs its kernel
  launches at drain, and the obs streams in the ``.backendH`` sibling layout
  merge into one timeline labelled ``fabric (router)`` and ``fabric (backend H)``.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from tests import fixtures, torch_worlds
from tests.conftest import assert_no_stream_leaks
from tests.test_torch_rank_plan import CHUNK, _leftovers
from variantcalling_tpu_torch.parallel import podrun

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent: the engine cannot be built")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = torch_worlds.write_pod_world(tmp_path_factory.mktemp("podrun_world"))
    single = Path(w["dir"]) / "single.vcf"
    proc = subprocess.run([sys.executable, "-m", "variantcalling_tpu_torch", "filter_variants_pipeline",
                           *_fwd(w, single)], env=_env(), cwd=w["dir"], timeout=240, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return {**w, "want": single.read_bytes()}


@pytest.fixture(autouse=True)
def _sentinel(tmp_path):
    yield
    assert_no_stream_leaks([tmp_path])


def _env(extra: dict | None = None) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("VCTPU_") and k not in ("XLA_FLAGS",)}
    env.update(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu", VCTPU_STREAM_CHUNK_BYTES=str(CHUNK), VCTPU_THREADS="2",
               VCTPU_IO_THREADS="2")
    env.update(extra or {})
    return env


def _fwd(w, out, backend="cpu") -> list[str]:
    return ["--input_file", w["vcf"], "--model_file", w["model"], "--model_name", w["model_name"],
            "--reference_file", w["fasta"], "--output_file", str(out), "--backend", backend]


def _podrun(w, out, *flags, module="variantcalling_tpu_torch.parallel.podrun", env=None, backend="cpu",
            cwd=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", module, "--timeout", "200", *flags, "--", *_fwd(w, out, backend)],
                          env=env or _env(), cwd=cwd or os.path.dirname(str(out)), timeout=240, capture_output=True,
                          text=True)


def test_a_classic_pod_writes_the_reference_launchers_bytes(world, tmp_path):
    out, ref = tmp_path / "pod.vcf", tmp_path / "ref.vcf"
    proc = _podrun(world, out, "--ranks", "2")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "from 2 ranks" in proc.stdout
    proc = _podrun(world, ref, "--ranks", "2", module="tools.podrun", cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    got, want = out.read_bytes(), ref.read_bytes()
    assert fixtures.strip_vctpu_header(got) == fixtures.strip_vctpu_header(want)
    assert fixtures.strip_vctpu_header(got) == fixtures.strip_vctpu_header(world["want"])
    assert b"##vctpu_ranks=n=2" in got and b"##vctpu_ranks=n=2" in want
    assert _leftovers(out) == _leftovers(ref) == []


def _kill_after_first_chunk(p: subprocess.Popen, out: Path, elastic: bool) -> bool:
    """SIGKILL one worker of the running pod ``p`` once its journal holds a chunk."""
    deadline = time.time() + 150
    while time.time() < deadline and p.poll() is None:
        try:
            workers = json.loads(Path(f"{out}.podrun.json").read_text()).get("workers") or []
        except (OSError, ValueError):
            workers = []
        for w in workers:
            seg = (f"{out}.span{w['span'][0]}-{w['span'][1]}.seg" if elastic
                   else f"{out}.rank{w['rank']}of2.seg")
            try:
                committed = len(Path(seg + ".journal").read_text().splitlines()) - 1
            except OSError:
                committed = 0
            if committed >= 1 and w.get("pid"):
                try:
                    os.kill(w["pid"], signal.SIGKILL)
                except ProcessLookupError:
                    continue
                return True
        time.sleep(0.02)
    return False


def test_an_elastic_pod_recovers_from_a_sigkill_in_the_same_launch(world, tmp_path):
    out = tmp_path / "pod.vcf"
    # a delay at every chunk keeps the workers mid-stream until the kill lands; the grace keeps the
    # straggler rule off the replacements while they start (a second or more here, under load)
    env = _env({"VCTPU_FAULTS": "pipeline.stage_hang:0@0.25", "VCTPU_OBS": "1"})
    p = subprocess.Popen([sys.executable, "-m", "variantcalling_tpu_torch.parallel.podrun", "--elastic", "--ranks",
                          "2", "--timeout", "200", "--grace", "30", "--", *_fwd(world, out)],
                         env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    killed = _kill_after_first_chunk(p, out, elastic=True)
    stdout, _ = p.communicate(timeout=280)
    assert killed, f"the kill never landed: {stdout[-2000:]}"
    assert p.returncode == 0, (p.returncode, stdout[-2500:])
    assert out.read_bytes() == world["want"]
    assert "membership: recut" in stdout or "membership: reassign" in stdout, stdout[-2500:]
    events = [json.loads(ln) for ln in Path(f"{out}.podrun.obs.jsonl").read_text().splitlines()]
    actions = [e.get("action") for e in events if e.get("kind") == "membership"]
    assert actions.count("join") >= 3 and ("recut" in actions or "reassign" in actions)
    assert _leftovers(out) == []


def test_a_killed_classic_worker_exits_3_and_a_relaunch_commits(world, tmp_path):
    out = tmp_path / "pod.vcf"
    env = _env({"VCTPU_FAULTS": "pipeline.stage_hang:0@0.25"})
    p = subprocess.Popen([sys.executable, "-m", "variantcalling_tpu_torch.parallel.podrun", "--ranks", "2",
                          "--timeout", "200", "--", *_fwd(world, out)],
                         env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    killed = _kill_after_first_chunk(p, out, elastic=False)
    stdout, _ = p.communicate(timeout=280)
    assert killed and p.returncode == podrun.EXIT_KILLED == 3, (p.returncode, stdout[-2500:])
    assert not out.exists()
    proc = _podrun(world, out, "--ranks", "2")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert fixtures.strip_vctpu_header(out.read_bytes()) == fixtures.strip_vctpu_header(world["want"])
    assert _leftovers(out) == []


def test_four_ranks_starting_together_share_one_sidecar(world, tmp_path):
    """A FASTA without its ``.venc`` sidecar: the four workers of a pod start
    together, each encodes the genome and writes the sidecar (a per-process
    temporary, then a rename), and each reads a whole one: the merged bytes
    are the single-rank run's and the sidecar is the single run's, with no
    temporary left."""
    for name in ("ref.fa", "ref.fa.fai"):
        shutil.copy(Path(world["fasta"]).parent / name, tmp_path / name)
    w = {**world, "fasta": str(tmp_path / "ref.fa")}
    out = tmp_path / "pod.vcf"
    proc = _podrun(w, out, "--ranks", "4")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert fixtures.strip_vctpu_header(out.read_bytes()) == fixtures.strip_vctpu_header(world["want"])
    # the same encoding (the header line names each FASTA's own path and stat)
    got, want = ((tmp_path / "ref.fa.venc").read_bytes(), Path(world["fasta"] + ".venc").read_bytes())
    assert got.split(b"\n", 2)[2] == want.split(b"\n", 2)[2] and got.startswith(b"VCENC1\n")
    assert not list(tmp_path.glob("*.tmp")) and _leftovers(out) == []


@pytest.mark.parametrize("mode,marker", [("steal_race", "claim_lost="), ("join_during_merge", "join_refused")])
def test_the_chaos_drills_keep_one_claimant(world, tmp_path, mode, marker):
    out = tmp_path / f"{mode}.vcf"
    proc = _podrun(world, out, "--elastic", "--ranks", "2", "--chaos", mode)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert marker in proc.stdout and out.read_bytes() == world["want"]
    assert _leftovers(out) == []


@pytest.mark.parametrize("flags,env,backend", [
    (("--ranks", "2"), {"VCTPU_THREADS": "1"}, "cpu"),
    (("--elastic", "--ranks", "2"), {"VCTPU_THREADS": "1"}, "cpu"),
    (("--ranks", "2"), {"CUDA_VISIBLE_DEVICES": ""}, "gpu"),
], ids=["classic-cannot-stream", "elastic-cannot-stream", "classic-no-card"])
def test_a_workers_configuration_error_is_the_pods_exit(world, tmp_path, flags, env, backend):
    if backend == "gpu" and torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = tmp_path / "pod.vcf"
    proc = _podrun(world, out, *flags, env=_env(env), backend=backend)
    assert proc.returncode == 2, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert not out.exists() and not [p for p in os.listdir(tmp_path) if ".seg" in p]
    for log in tmp_path.glob("*.podlog"):
        log.unlink()


def test_a_fabric_of_processes_serves_the_batch_bytes_and_drains_clean(world, tmp_path):
    from variantcalling_tpu_torch.serve import backend as backend_mod
    from variantcalling_tpu_torch.serve import transport

    base = str(tmp_path / "fab")
    h = podrun.start_fabric(base, 2, timeout=120, env=_env(), backend_env={"CUDA_VISIBLE_DEVICES": ""},
                            backend="cpu")
    try:
        with open(f"/proc/{h.router.pid}/maps") as fh:
            assert "libtorch" not in fh.read()
        params = {"model": world["model"], "model_name": world["model_name"], "reference": world["fasta"],
                  "output_name": "served.vcf", "ranks": 2, "deadline_s": 120.0}
        out = tmp_path / "served.vcf"
        code, stats = transport.client_filter(h.router_address, params, world["vcf_gz"], str(out))
        assert code == 200, stats
        assert (stats["n"], stats["spans"], stats["respans"]) == (world["n"], 2, 0)
        assert fixtures.strip_vctpu_header(out.read_bytes()) == fixtures.strip_vctpu_header(world["want"])
    finally:
        report = podrun.stop_fabric(h)
    for doc in [report["router"], *report["backends"].values()]:
        assert doc["rc"] == 0 and doc["status"] == "drained" and doc["leaked"] == [], doc
    assert sorted(report["backends"]) == [1, 2]
    drained = backend_mod.DRAIN_LOG.split(";")[0]
    for i in (1, 2):
        log = Path(f"{base}.backend{i}.podlog").read_text()
        assert drained in log and "launches in this process: wide 0, tree_step 0" in log
    proc = subprocess.run([sys.executable, "-m", "variantcalling_tpu_torch", "obs", "summary", "--json",
                           f"{base}.obs.jsonl"], env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout)
    assert summary["run"]["tool"] == "fabric" and summary["throughput"]["records"] == world["n"]
    trace = tmp_path / "fab.trace.json"
    proc = subprocess.run([sys.executable, "-m", "variantcalling_tpu_torch", "obs", "export", "-o", str(trace),
                           f"{base}.obs.jsonl"], env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = {e["args"]["name"] for e in json.loads(trace.read_text())["traceEvents"] if e["name"] == "process_name"}
    assert names == {"fabric (router)", "fabric (backend 1)", "fabric (backend 2)"}
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == sorted(["served.vcf", "fab.trace.json", "fab.obs.jsonl", "fab.obs.jsonl.backend1",
                           "fab.obs.jsonl.backend2"] + [f"fab.{t}.{x}" for t in ("backend1", "backend2", "router")
                                                        for x in ("ready", "status", "podlog")]), left


@pytest.mark.parametrize("argv,message", [
    (["--ranks", "2", "--chaos", "steal_race", "--"], "--chaos requires --elastic"),
    (["--ranks", "2", "--fabric", "--", "--output_file", "x.vcf"], "no forwarded CLI arguments"),
    (["--ranks", "2", "--", "--input_file", "x.vcf"], "--output_file"),
    (["--ranks", "0", "--", "--output_file", "x.vcf"], "--ranks must be positive"),
    (["--ranks", "2"], "after `--`"),
    (["--ranks", "2", "--worker-env", "nope", "--", "--output_file", "x.vcf"], "bad --worker-env"),
])
def test_usage_errors_exit_2(tmp_path, capsys, monkeypatch, argv, message):
    monkeypatch.chdir(tmp_path)
    if argv[-1] == "--":
        argv = [*argv, "--output_file", "x.vcf"]
    assert podrun.main(argv) == podrun.EXIT_USAGE == 2
    assert message in capsys.readouterr().err and os.listdir(tmp_path) == []
