"""The port's csI-ADMM training runtime against the reference's, on the CPU.

Held here, each against `repro.distributed.ConsensusRuntime` (on a
one-device mesh, as the reference's launcher runs it) or its tests:

- ``row_weights`` for uncoded, fractional and cyclic codes at several
  (K, S) and random alive masks (absolute 1e-6: the weights are float32
  near 1 / (K P); both solve in float64);
- the reference's exactness and masking tests, ported: the decoded
  gradient is invariant to which ECNs straggle (eq. 6), incremental mode
  commits one agent, and z moves by exactly the committed deltas (eq. 4c);
- the train CLI's consensus mode: the host draws (coded allocation,
  stragglers) bit for bit the reference launcher's, and a run of the CLI.

The LM models' train steps against the reference's are in
tests/test_torch_consensus_lm.py.
"""

import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.core.coding import make_code as r_make_code
from repro.data import agent_token_streams as r_streams
from repro.data import make_lm_batch as r_make_batch
from repro.distributed import ConsensusConfig as RConfig
from repro.distributed import ConsensusRuntime as RRuntime
from repro_torch.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import train


def _mesh():
    return jax.make_mesh((1, 1, 1), ("agent", "data", "model"))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).cpu().numpy()
    return np.asarray(t, np.float64)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _normwise(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---- row weights -----------------------------------------------------------


@pytest.mark.parametrize(
    "scheme,K,S",
    [("uncoded", 4, 0), ("fractional", 4, 1), ("fractional", 6, 2),
     ("cyclic", 3, 1), ("cyclic", 4, 1), ("cyclic", 5, 2)],
)
def test_row_weights_match_reference(scheme, K, S):
    A, P_rows = 3, 2
    rt_t = ConsensusRuntime(_Quad(), ConsensusConfig(n_agents=A, K=K, S=S, scheme=scheme))
    rt_r = RRuntime(None, RConfig(n_agents=A, K=K, S=S, scheme=scheme), _mesh())
    rows = K * (S + 1) * P_rows
    rng = np.random.default_rng(K * 10 + S)
    for _ in range(4):
        alive = np.ones((A, K), bool)
        for a in range(A):
            alive[a, rng.choice(K, size=int(rng.integers(0, S + 1)), replace=False)] = False
        got = rt_t.row_weights(alive, rows)
        want = np.asarray(rt_r.row_weights(jnp.asarray(alive), rows))
        assert got.shape == want.shape == (A, rows) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        dead_rows = np.repeat(~alive, (S + 1) * P_rows, axis=1)
        assert (got[dead_rows] == 0).all()


# ---- the reference's exactness and masking tests, on the port ----------------


class _Quad(nn.Module):
    """Per-row quadratic loss 0.5 ||w - t_b||^2 (its gradient is linear in
    the rows), the reference tests' stub model."""

    def __init__(self, p: int = 4):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(p, dtype=torch.float32))

    @property
    def device(self):
        return self.w.device

    def loss(self, batch):
        d = self.w[None] - batch["tokens"].to(torch.float32)
        row_loss = 0.5 * (d * d).sum(-1)
        w = batch.get("loss_weights")
        loss = row_loss.mean() if w is None else (w * row_loss).sum()
        return loss, {"nll": loss}


def _coded_batch(rng, A, K, S, P_rows, p, support):
    distinct = rng.standard_normal((A, K, P_rows, p)).astype(np.float32)
    rows = np.zeros((A, K, S + 1, P_rows, p), np.float32)
    for j in range(K):
        for u, t in enumerate(support[j]):
            rows[:, j, u] = distinct[:, t]
    return distinct, rows.reshape(A * K * (S + 1) * P_rows, p)


def _copy(state):
    return {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in state.items()}


@pytest.mark.parametrize("scheme,K,S", [("cyclic", 4, 1), ("fractional", 4, 1), ("cyclic", 5, 2)])
def test_decoded_gradient_invariant_to_stragglers(scheme, K, S):
    """Every pattern of S dead ECNs decodes to the uncoded mean gradient
    over the distinct rows (eq. 6); tolerances as the reference's test."""
    A, P_rows, p = 2, 3, 4
    rt = ConsensusRuntime(_Quad(p), ConsensusConfig(n_agents=A, K=K, S=S, scheme=scheme))
    sup = [rt.cfg.code().support(j) for j in range(K)]
    distinct, flat = _coded_batch(np.random.default_rng(0), A, K, S, P_rows, p, sup)
    expect = -distinct.reshape(A, K * P_rows, p).mean(axis=1)
    rows = flat.shape[0] // A
    batch_rows = flat.reshape(A, rows, p)

    def decoded_grad(alive):
        w = rt.row_weights(alive, rows)
        return np.stack([-(w[a][:, None] * batch_rows[a]).sum(0) for a in range(A)])

    np.testing.assert_allclose(decoded_grad(np.ones((A, K), bool)), expect, rtol=1e-5, atol=1e-6)
    for dead in itertools.combinations(range(K), S):
        alive = np.ones((A, K), bool)
        alive[:, list(dead)] = False
        np.testing.assert_allclose(decoded_grad(alive), expect, rtol=1e-4, atol=1e-5)


def test_incremental_mode_updates_one_agent():
    A, K, S, P_rows, p = 4, 4, 1, 2, 3
    rt = ConsensusRuntime(
        _Quad(p), ConsensusConfig(n_agents=A, K=K, S=S, scheme="fractional", mode="incremental")
    )
    sup = [rt.cfg.code().support(j) for j in range(K)]
    _, flat = _coded_batch(np.random.default_rng(1), A, K, S, P_rows, p, sup)
    state = rt.init_state()
    old = _copy(state)
    new, _ = rt.train_step(state, {"tokens": torch.from_numpy(flat)}, np.ones((A, K), bool))
    assert new["k"] == 1
    for key in ("x", "y"):  # the active agent of k = 1 is (k - 1) % A = 0
        changed = (new[key]["w"] != old[key]["w"]).any(dim=1)
        assert changed[0] and not changed[1:].any()
        assert torch.equal(new[key]["w"][1:], old[key]["w"][1:])  # bit for bit


@pytest.mark.parametrize("mode", ["incremental", "parallel"])
def test_z_update_conservation(mode):
    """z+ == z + (1/A) sum_a mask_a [dx_a - dy_a / rho] (eq. 4c) at every
    step, recomputed in float64 (rtol 1e-5, atol 1e-6 as the reference's)."""
    A, K, S, P_rows = 3, 3, 1, 2
    cfg = ConsensusConfig(n_agents=A, K=K, S=S, scheme="cyclic", mode=mode, rho=0.7)
    model = _Quad(3)
    with torch.no_grad():
        model.w.copy_(torch.tensor([0.3, -0.2, 0.5]))
    rt = ConsensusRuntime(model, cfg)
    sup = [cfg.code().support(j) for j in range(K)]
    _, flat = _coded_batch(np.random.default_rng(0), A, K, S, P_rows, 3, sup)
    state = rt.init_state()
    for _ in range(5):
        old = _copy(state)
        state, _ = rt.train_step(state, {"tokens": torch.from_numpy(flat)}, np.ones((A, K), bool))
        dx = _np(state["x"]["w"]) - _np(old["x"]["w"])
        dy = _np(state["y"]["w"]) - _np(old["y"]["w"])
        expect = _np(old["z"]["w"]) + (dx - dy / cfg.rho).sum(0) / A
        np.testing.assert_allclose(_np(state["z"]["w"]), expect, rtol=1e-5, atol=1e-6)


def _args(**kw):
    base = dict(agents=2, ecns=4, stragglers=1, scheme="cyclic", rho=1.0, c_tau=20.0,
                c_gamma=0.1, consensus_mode="incremental", seed=0, steps=2, batch=8,
                seq=16, log_every=10, ckpt_dir=None, ckpt_every=100)
    base.update(kw)
    return SimpleNamespace(**base)


# ---- the CLI ----------------------------------------------------------------


def test_consensus_host_draws_are_the_reference_bit_for_bit():
    """The coded allocation and straggler draws of the reference's
    launcher (its loop, run here on its own data functions)."""
    args = _args(steps=3, agents=3, ecns=5, stragglers=2, batch=90, seq=16)
    code_r = r_make_code("cyclic", 5, 2, seed=0)
    sup = [code_r.support(j) for j in range(5)]
    streams = r_streams(3, 512, seed=0)
    rng = np.random.default_rng(7)
    got = list(train.consensus_batches(args, ConsensusConfig(n_agents=3, K=5, S=2).code(), 512))
    assert len(got) == 3
    for batch, alive in got:
        rows = []
        for a in range(3):
            parts = [r_make_batch(streams[a], 2, 16) for _ in range(5)]
            for j in range(5):
                for t in sup[j]:
                    rows.append(parts[t])
        want = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
        want_alive = np.ones((3, 5), bool)
        for a in range(3):
            want_alive[a, rng.choice(5, size=2, replace=False)] = False
        assert set(batch) == set(want)
        for k in want:
            assert batch[k].dtype == want[k].dtype and np.array_equal(batch[k], want[k])
        assert np.array_equal(alive, want_alive)


def test_train_cli_consensus_mode_runs_on_cpu(capsys):
    out = train.main([
        "--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu", "--mode", "consensus",
        "--steps", "2", "--batch", "8", "--seq", "16", "--consensus-mode", "parallel",
    ])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert np.isfinite(out["residuals"]).all() and out["state"]["k"] == 2
    assert "mode=consensus" in capsys.readouterr().out
