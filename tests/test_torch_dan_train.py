"""The DAN's training half in the port against ``variantcalling_tpu.models.dan``, on the CPU.

Inputs are made from a seed with numpy; the reference's weights (after a
few steps of its own, so the output head is not zero) and its optimiser
state are carried across with ``models/convert.py``. Tolerances:

- ``dtype="float32"`` (full float32 both sides): logits, loss and gradients
  to rtol 1e-5 (gradients: atol 1e-6 of the largest); after 20 steps on the
  same batches, parameters to atol 1e-5 (1 % of the learning rate), the
  Adam state's ``mu`` to atol 1e-6, ``nu`` to atol 1e-9 (rtol 1e-4 each),
  ``count`` equal;
- the default ``bfloat16`` (XLA and torch round bf16 products and GELUs at
  different points, so no bit equality): the loss at each of 20 steps
  within 1 %, the held-out scores after them within 5e-3, and each
  parameter within 40 learning rates (Adam moves an element by about one
  learning rate a step, so two runs whose near-zero gradients take opposite
  signs part by at most two a step); the share of elements more than half a
  learning rate apart is printed.

Checkpoints (``io/checkpoint.py``): save, restore, keep the newest two, a
crash's temporary file ignored, and an orbax-shaped directory refused by
the CLI with exit 2.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variantcalling_tpu.models import dan as jd
from variantcalling_tpu_torch.io import checkpoint
from variantcalling_tpu_torch.models import convert
from variantcalling_tpu_torch.models import dan as td

LR = 1e-3
N_ROWS, N_TRAIN = 2048, 1536


def _cfg(dtype: str, n_layers: int = 2):
    cfg_j = jd.DanConfig(n_numeric=6, embed_dim=4, hidden=32, n_layers=n_layers, dtype=dtype, learning_rate=LR)
    return cfg_j, td.DanConfig(**dataclasses.asdict(cfg_j))


def _data(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    numeric = rng.normal(size=(N_ROWS, 6)).astype(np.float32)
    return {"numeric": numeric,
            "motif_left": rng.integers(0, td.MOTIF_VOCAB, N_ROWS).astype(np.int32),
            "motif_right": rng.integers(0, td.MOTIF_VOCAB, N_ROWS).astype(np.int32),
            "label": ((numeric[:, 0] + rng.normal(0, 0.5, N_ROWS)) > 0).astype(np.float32),
            "weight": rng.choice([1.0, 2.0], N_ROWS).astype(np.float32)}


def _batches(seed: int, n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed + 100)
    return [rng.integers(0, N_TRAIN, 256) for _ in range(n)]


def _jax_batch(data, idx):
    return {k: jnp.asarray(v[idx]) for k, v in data.items()}


def _torch_batch(data, idx):
    return {k: torch.from_numpy(v[idx]) for k, v in data.items()}


def _numpy(tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in tree.items()}


def _carried(dtype: str, seed: int = 0, warm_steps: int = 0, n_layers: int = 2):
    """Both packages' configs, params and optimiser states, the port's carried
    from the reference's after ``warm_steps`` of the reference's own steps."""
    cfg_j, cfg_t = _cfg(dtype, n_layers)
    opt = jd.make_optimizer(cfg_j)
    p_j = jd.init_params(cfg_j, jax.random.PRNGKey(seed))
    s_j = opt.init(p_j)
    data = _data(seed)
    for idx in _batches(seed + 50, warm_steps):
        p_j, s_j, _ = jd.train_step(cfg_j, opt, p_j, s_j, _jax_batch(data, idx))
    adam = s_j[0]
    p_t = convert.dan_params_from_reference(_numpy(p_j))
    s_t = convert.adam_state_from_reference(adam.count, _numpy(adam.mu), _numpy(adam.nu))
    return cfg_j, cfg_t, opt, (p_j, s_j), (p_t, s_t), data


@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_init_params_shapes_scales_and_zero_heads(n_layers):
    cfg_j, cfg_t = _cfg("bfloat16", n_layers)
    want = jd.init_params(cfg_j, jax.random.PRNGKey(0))
    got = td.init_params(cfg_t, seed=3)
    assert list(got) == list(want) == td.param_names(n_layers)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32 and g.device.type == "cpu", k
        if k.startswith("b_") or k == "w_out":
            assert not g.any(), k
    in_dim = cfg_t.n_numeric + 2 * cfg_t.embed_dim
    scales = {"motif_embed": 0.02, "w_in": 1 / np.sqrt(in_dim),
              **{f"w_{i}": 1 / np.sqrt(cfg_t.hidden) for i in range(n_layers - 1)}}
    for k, scale in scales.items():
        for tree in (got, _numpy(want)):
            std = float(np.std(np.asarray(tree[k])))
            assert abs(std / scale - 1) < 0.1, (k, std, scale)
    again = td.init_params(cfg_t, seed=3)
    other = td.init_params(cfg_t, seed=4)
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["w_in"], other["w_in"])


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_forward_loss_and_gradients_match_reference(dtype, rtol):
    """From carried weights (5 warm-up steps, so no zero head): the logits,
    the loss and every gradient. bf16: logits and gradients to 3e-2 of their
    largest magnitude, the loss to 1e-3."""
    cfg_j, cfg_t, _, (p_j, _), (p_t, _), data = _carried(dtype, warm_steps=5)
    idx = _batches(7, 1)[0]
    bj, bt = _jax_batch(data, idx), _torch_batch(data, idx)
    with td.full_float32():
        got = td.forward(cfg_t, p_t, bt["numeric"], bt["motif_left"], bt["motif_right"]).numpy()
    want = np.asarray(jd.forward(cfg_j, p_j, bj["numeric"], bj["motif_left"], bj["motif_right"]))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())

    loss_j, grads_j = jax.value_and_grad(lambda p: jd.loss_fn(cfg_j, p, bj))(p_j)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p_t.items()}
    with td.full_float32():
        loss_t = td.loss_fn(cfg_t, leaves, bt)
    grads_t = dict(zip(leaves, torch.autograd.grad(loss_t, list(leaves.values()))))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5 if dtype == "float32" else 1e-3)
    for k, gj in grads_j.items():
        gj = np.asarray(gj)
        scale = max(np.abs(gj).max(), 1e-12)
        atol = (1e-6 if dtype == "float32" else rtol) * scale
        np.testing.assert_allclose(grads_t[k].numpy(), gj, rtol=rtol, atol=atol, err_msg=k)


def test_loss_weights_and_valid_mask_match_reference():
    cfg_j, cfg_t, _, (p_j, _), (p_t, _), data = _carried("float32", warm_steps=3)
    idx = _batches(9, 1)[0]
    valid = (np.arange(len(idx)) % 3 != 0)
    bj, bt = _jax_batch(data, idx), _torch_batch(data, idx)
    for extra in ({"valid": valid}, {"weight": None}, {"weight": np.zeros(len(idx), np.float32)}):
        bj2 = {**bj, **{k: jnp.asarray(v) for k, v in extra.items() if v is not None}}
        bt2 = {**bt, **{k: torch.from_numpy(v) for k, v in extra.items() if v is not None}}
        for k, v in extra.items():
            if v is None:
                del bj2[k], bt2[k]
        with td.full_float32():
            got = float(td.loss_fn(cfg_t, p_t, bt2))
        np.testing.assert_allclose(got, float(jd.loss_fn(cfg_j, p_j, bj2)), rtol=1e-5, atol=1e-7)


def _twenty_steps(dtype: str, seed: int):
    cfg_j, cfg_t, opt, (p_j, s_j), (p_t, s_t), data = _carried(dtype, seed=seed)
    losses = []
    for idx in _batches(seed, 20):
        p_j, s_j, loss_j = jd.train_step(cfg_j, opt, p_j, s_j, _jax_batch(data, idx))
        p_t, s_t, loss_t = td.train_step(cfg_t, p_t, s_t, _torch_batch(data, idx))
        losses.append((float(loss_j), float(loss_t)))
    return cfg_j, cfg_t, (p_j, s_j), (p_t, s_t), data, np.asarray(losses)


@pytest.mark.parametrize("seed", [0, 1])
def test_twenty_float32_steps_match_reference_state(seed):
    """Params and optax's ``ScaleByAdamState`` (count, mu, nu) after 20
    steps at ``dtype="float32"`` from the same weights and batches."""
    _, _, (p_j, s_j), (p_t, s_t), _, losses = _twenty_steps("float32", seed)
    adam = s_j[0]
    assert type(adam).__name__ == "ScaleByAdamState" and int(adam.count) == int(s_t.count) == 20
    assert s_t.count.dtype == torch.int32
    for k in p_j:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]), rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(s_t.mu[k].numpy(), np.asarray(adam.mu[k]), rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(s_t.nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-4, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twenty_bfloat16_steps_stay_within_the_stated_tolerance(seed):
    cfg_j, cfg_t, (p_j, _), (p_t, _), data, losses = _twenty_steps("bfloat16", seed)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-2)
    held = {k: v[N_TRAIN:] for k, v in data.items()}
    want = np.asarray(jd.predict_score(cfg_j, p_j, *(jnp.asarray(held[k]) for k in
                                                      ("numeric", "motif_left", "motif_right"))))
    got = td.predict_score(cfg_t, p_t, *(torch.from_numpy(held[k]) for k in
                                         ("numeric", "motif_left", "motif_right"))).numpy()
    assert np.abs(got - want).max() <= 5e-3
    apart = {}
    for k in p_j:
        diff = np.abs(p_t[k].numpy() - np.asarray(p_j[k]))
        assert diff.max() <= 40 * LR, (k, diff.max() / LR)
        apart[k] = float((diff > 0.5 * LR).mean())
    print(f"seed {seed}: share of elements more than lr/2 apart after 20 bf16 steps: {apart}")


def test_adamw_saturates_its_count_as_optax_does():
    _, cfg_t = _cfg("float32")
    params = td.init_params(cfg_t, seed=0)
    state = td.adamw_init(params)._replace(count=torch.tensor(2**31 - 1, dtype=torch.int32))
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    _, new = td.adamw_update(cfg_t, grads, state, params)
    assert int(new.count) == 2**31 - 1


def _state(seed: int):
    _, cfg_t = _cfg("float32")
    params = td.init_params(cfg_t, seed=seed)
    grads = {k: torch.full_like(v, 0.5) for k, v in params.items()}
    return td.adamw_update(cfg_t, grads, td.adamw_init(params), params)


def test_checkpoint_save_restore_and_keep_two(tmp_path):
    d = str(tmp_path / "ck")
    saved = {}
    for step in (9, 19, 29):
        params, state = _state(step)
        path = checkpoint.save(d, step, params, state)
        assert os.path.basename(path) == f"dan_ckpt_step_{step:09d}.npz"
        saved[step] = (params, state)
    assert checkpoint.steps(d) == [19, 29] and checkpoint.latest(d) == 29
    assert sorted(os.listdir(d)) == ["dan_ckpt_step_000000019.npz", "dan_ckpt_step_000000029.npz"]
    for step in (19, 29):
        params, state = checkpoint.restore(d, step)
        want_p, want_s = saved[step]
        assert list(params) == list(want_p) and int(state.count) == int(want_s.count) == 1
        assert state.count.dtype == torch.int32
        for k in want_p:
            assert torch.equal(params[k], want_p[k]) and torch.equal(state.mu[k], want_s.mu[k])
            assert torch.equal(state.nu[k], want_s.nu[k])


def test_checkpoint_crash_leaves_the_previous_one_readable(tmp_path, monkeypatch):
    """A save that dies before its rename leaves only a temporary file, which
    no listing takes for a step; the previous step restores."""
    d = str(tmp_path / "ck")
    params, state = _state(1)
    checkpoint.save(d, 9, params, state)

    def die(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(checkpoint.os, "replace", die)
    with pytest.raises(OSError):
        checkpoint.save(d, 19, params, state)
    monkeypatch.undo()
    assert checkpoint.latest(d) == 9
    assert any(n.endswith(".tmp") for n in os.listdir(d))
    restored, _ = checkpoint.restore(d, 9)
    assert all(torch.equal(restored[k], params[k]) for k in params)


def test_an_orbax_checkpoint_dir_is_refused_with_exit_2(tmp_path):
    from tests.unit.test_somatic_and_dan import _training_h5
    from variantcalling_tpu_torch.__main__ import main as torch_main

    h5 = str(tmp_path / "conc.h5")
    _training_h5(h5, np.random.default_rng(0), n=200)
    ck = tmp_path / "ck"
    (ck / "29" / "default").mkdir(parents=True)
    (ck / "19").mkdir()
    before = sorted(p.name for p in ck.rglob("*"))
    rc = torch_main(["train_dan", "--input_file", h5, "--output_file_prefix", str(tmp_path / "p"),
                     "--n_steps", "5", "--hidden", "8", "--embed_dim", "2", "--checkpoint_dir", str(ck),
                     "--backend", "cpu"])
    assert rc == 2
    assert sorted(p.name for p in ck.rglob("*")) == before and not (tmp_path / "p.pkl").exists()
    with pytest.raises(checkpoint.ForeignCheckpoint):
        checkpoint.check_not_orbax(str(ck))
