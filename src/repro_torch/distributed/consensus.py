"""csI-ADMM as a training feature: the paper's Algorithm 2 over A agents
(port of `repro.distributed.consensus`, one process).

A agents with disjoint token streams each hold a primal/dual pair
(x_a, y_a); z is the consensus (served) model. Each agent's batch arrives
coded-allocated: partition t of its K partitions is repeated on the S + 1
ECNs whose encode rows touch it, rows laid out (A, K, S + 1, P) along dim
0. The encode/decode folds into one row-weighted backward pass: gradients
are linear in per-example losses, so ECN j's message sum_t B[j, t] g_t
followed by the agent's decode sum_j a_j g_j is the gradient of the loss
with row weight a_j * B[j, t(row)] / (K * P). The decode vector a is
min-norm for the alive ECNs (``row_weights``); a dead ECN's rows weigh 0.

One step (eqs. 5a, 5b, 4c), with tau = c_tau sqrt(k), gamma = c_gamma /
sqrt(k), in float32 and cast to the parameter dtype:

  x_a+ = (tau x_a + rho z + y_a - g_a) / (rho + tau)
  y_a+ = y_a + rho gamma (z - x_a+)
  z+   = z + (1/A) sum_a mask_a [(x_a+ - x_a) - (y_a+ - y_a) / rho]

"incremental" (the paper): only agent (k - 1) mod A commits; "parallel":
every agent commits.

Placement: the agents run one after another in this process. By default
every agent lives on the model's device, as the reference's launcher
runs them on its one-device mesh. Given ``devices`` (D of them, the
first the model's), the runtime places the agent axis as the reference's
mesh does: agent a's x_a, y_a and batch rows live on ``devices[a % D]``;
each device holds one workspace module (the model on the first, a
replica on the others) and one copy of z. Each committing agent's f32
z-delta moves to every copy of z and the adds run in agent order, so
every copy computes the same z+, and D devices give bit for bit the
one-device result wherever the arithmetic is the same: this copy is the
token traversal, one model's worth of traffic per incremental step. The
residual and the metrics are reduced on ``devices[0]``. The reference's
mesh plumbing (``make_consensus_mesh``, ``state_shape``,
``state_specs``, ``lower_train_step``) exists for XLA's lowering and is
not ported (ROADMAP Queue 1, item 15).

How the port differs in form, not in result:
- an agent's loss is evaluated by copying x_a into the module's
  parameters (the module is the workspace; kernels, remat and autograd
  then run as in plain training), not by a functional call;
- the state's x and y are updated in place (the returned state shares
  its tensors with the one passed in): a full-size model cannot hold a
  second copy of A primal/dual pairs;
- in incremental mode an agent that does not commit runs its forward
  only, for the metrics (the reference computes and masks its gradient:
  the result is the same).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.coding import GradientCode, make_code

__all__ = ["ConsensusConfig", "ConsensusRuntime"]


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """Hyper-parameters of the csI-ADMM runtime (the reference's)."""

    n_agents: int = 2
    K: int = 4  # ECN groups per agent
    S: int = 1  # tolerated stragglers per agent
    scheme: str = "cyclic"  # "uncoded" | "fractional" | "cyclic"
    rho: float = 1.0
    c_tau: float = 0.1  # tau^k = c_tau sqrt(k)
    c_gamma: float = 1.0  # gamma^k = c_gamma / sqrt(k)
    mode: str = "incremental"  # "incremental" (paper) | "parallel"
    seed: int = 0

    def code(self) -> GradientCode:
        return make_code(self.scheme, self.K, self.S, seed=self.seed)


class ConsensusRuntime:
    """Consensus state and train step for one model. Turns the model's
    parameters' gradients on (they are created without).

    ``devices``: where the agents live (agent a on ``devices[a % D]``);
    the first must be the model's device, which is also the default. The
    replicas on the other devices copy the model as it is when the
    runtime is built (its dtypes and config).

    State: ``x`` and ``y`` map each parameter name of the model to agent
    a's tensor at index ``a``: one (A, ...) tensor on one device, a list
    of A tensors (each on its agent's device) on several. ``z`` maps each
    name to a tensor of the parameter's shape on ``devices[0]`` (the
    served model); on several devices ``z_rep`` holds a copy of z for
    each of ``devices[1:]``, bit for bit. ``k`` is the step count (an
    int)."""

    def __init__(self, model, cfg: ConsensusConfig, devices: Optional[Sequence] = None):
        if cfg.mode not in ("incremental", "parallel"):
            raise ValueError(f"unknown consensus mode {cfg.mode!r}")
        self.model = model
        self.cfg = cfg
        model.requires_grad_(True)
        home = next(model.parameters()).device
        self.devices = [torch.device(d) for d in (devices or [home])]
        if self.devices[0] != home:
            raise ValueError(
                f"devices[0] must be the model's device {home}, got {self.devices[0]}"
            )
        # One workspace module a device: the model, then its replicas.
        self.workspaces = [model] + [copy.deepcopy(model).to(d) for d in self.devices[1:]]
        code = cfg.code()
        # ECN j's u-th stored partition and its encode coefficient
        # B[j, supp(j)[u]], float32 as the reference keeps them.
        sup = np.stack([code.support(j) for j in range(cfg.K)])  # (K, S+1)
        if sup.shape[1] != cfg.S + 1:
            raise ValueError(
                f"{cfg.scheme} code stores {sup.shape[1]} partitions/ECN, "
                f"expected S+1={cfg.S + 1}"
            )
        self.B_enc = code.B.astype(np.float32)  # (K, K)
        self.B_sel = np.take_along_axis(code.B, sup, axis=1).astype(np.float32)

    # -- state ---------------------------------------------------------------

    def init_state(self) -> dict:
        """z = the model's current weights, x_a = z for every agent, y = 0."""
        A, devs = self.cfg.n_agents, self.devices
        z = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        if len(devs) == 1:
            return {
                "x": {n: p.expand(A, *p.shape).clone() for n, p in z.items()},
                "y": {n: p.new_zeros((A, *p.shape)) for n, p in z.items()},
                "z": z,
                "k": 0,
            }
        at = [devs[a % len(devs)] for a in range(A)]
        return {
            "x": {n: [p.to(d, copy=True) for d in at] for n, p in z.items()},
            "y": {n: [torch.zeros(p.shape, dtype=p.dtype, device=d) for d in at]
                  for n, p in z.items()},
            "z": z,
            "z_rep": [{n: p.to(d, copy=True) for n, p in z.items()} for d in devs[1:]],
            "k": 0,
        }

    # -- step ----------------------------------------------------------------

    def row_weights(self, alive: np.ndarray, rows_per_agent: int) -> np.ndarray:
        """(A, rows_per_agent) float32 loss weights from the (A, K) alive
        mask, on the host.

        Each agent's decode vector is the min-norm a with a^T B_alive =
        1^T, solved in float64 (``pinv`` with rtol 1e-6, as the
        reference's x64 solve); a dead ECN's coefficient is set to exactly
        0. Row weight a_j * B[j, sup(j)[u]] / (K * P), in float32. (numpy's
        ``rcond`` is the relative cutoff that jax calls ``rtol``.)"""
        cfg = self.cfg
        K, S1 = cfg.K, cfg.S + 1
        P_rows = rows_per_agent // (K * S1)
        alive = np.asarray(alive, bool)
        Bm = self.B_enc.astype(np.float64)[None] * alive[..., None].astype(np.float64)
        ones = np.ones((K,), np.float64)
        a = np.stack([np.linalg.pinv(M.T, rcond=1e-6) @ ones for M in Bm])
        a = np.where(alive, a, 0.0).astype(np.float32)
        w = a[:, :, None] * self.B_sel[None] / np.float32(K * P_rows)  # (A, K, S+1)
        return np.repeat(w[..., None], P_rows, axis=-1).reshape(alive.shape[0], rows_per_agent)

    def train_step(
        self, state: dict, batch: Dict[str, torch.Tensor], alive
    ) -> Tuple[dict, dict]:
        """One csI-ADMM iteration (eqs. 5a, 5b, 4c).

        batch: tensors of (A * K * (S + 1) * P, ...) rows in coded
        allocation order (each agent's rows move to its device); alive:
        the (A, K) ECN response mask (numpy). Updates x and y in place and
        returns the state with the new z (and its copies) and k, and the
        metrics ``loss`` and ``nll`` (means over all agents),
        ``consensus_residual`` (the mean over agents of ||x_a+ - z+||),
        ``tau`` and ``gamma``, on ``devices[0]``."""
        cfg = self.cfg
        A = cfg.n_agents
        devs = self.devices
        D = len(devs)
        k = state["k"] + 1
        kf = np.float32(k)
        tau = np.float32(cfg.c_tau) * np.sqrt(kf)
        gamma = np.float32(cfg.c_gamma) / np.sqrt(kf)
        rho = np.float32(cfg.rho)
        rho_tau = float(rho + tau)
        rho_gamma = float(rho * gamma)
        tau, rho = float(tau), float(rho)

        rows = batch["tokens"].shape[0] // A
        w = torch.from_numpy(self.row_weights(alive, rows))
        commit = {(k - 1) % A} if cfg.mode == "incremental" else set(range(A))
        X, Y = state["x"], state["y"]
        Zs = [state["z"], *state.get("z_rep", ())]  # z's copy on each device
        f32 = torch.float32
        # Each device's sum of the committed deltas, in agent order.
        zd = [{n: torch.zeros(p.shape, dtype=f32, device=p.device) for n, p in Z.items()}
              for Z in Zs]
        losses, nlls = [], []
        for a in range(A):
            d = a % D
            dev, Z = devs[d], Zs[d]
            params = dict(self.workspaces[d].named_parameters())
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(X[n][a])
            ab = {key: v[a * rows:(a + 1) * rows].to(dev) for key, v in batch.items()}
            ab["loss_weights"] = w[a].to(dev)
            if a not in commit:
                with torch.no_grad():
                    loss, metrics = self.workspaces[d].loss(ab)
            else:
                for p in params.values():
                    p.grad = None
                loss, metrics = self.workspaces[d].loss(ab)
                loss.backward()
                with torch.no_grad():
                    for n, p in params.items():
                        x, y, z = X[n][a], Y[n][a], Z[n]
                        x32, y32, z32 = x.to(f32), y.to(f32), z.to(f32)
                        g32 = torch.zeros_like(x32) if p.grad is None else p.grad.to(f32)
                        # eq. (5a), then (5b) from the rounded x+.
                        xp = ((tau * x32 + rho * z32 + y32 - g32) / rho_tau).to(x.dtype)
                        xp32 = xp.to(f32)
                        yp = (y32 + rho_gamma * (z32 - xp32)).to(y.dtype)
                        delta = (xp32 - x32) - (yp.to(f32) - y32) / rho
                        for acc in zd:  # the token traversal
                            acc[n] += delta.to(acc[n].device)
                        x.copy_(xp)
                        y.copy_(yp)
                        p.grad = None
            losses.append(loss.detach().to(f32).to(devs[0]))
            nlls.append(metrics["nll"].detach().to(f32).to(devs[0]))

        # eq. (4c): z+ = z + (1/A) sum_a mask_a delta_a, on every device.
        scale = 1.0 / A
        with torch.no_grad():
            z_new = [{n: (Z[n].to(f32) + scale * acc[n]).to(Z[n].dtype) for n in Z}
                     for Z, acc in zip(Zs, zd)]
            del zd
            sq = [torch.zeros((), dtype=f32, device=devs[a % D]) for a in range(A)]
            for n in z_new[0]:
                for a in range(A):
                    diff = X[n][a].to(f32) - z_new[a % D][n].to(f32)
                    sq[a] += (diff * diff).sum()
        new_state = {"x": X, "y": Y, "z": z_new[0], "k": k}
        if D > 1:
            new_state["z_rep"] = z_new[1:]
        metrics = {
            "loss": torch.stack(losses).mean(),
            "nll": torch.stack(nlls).mean(),
            "consensus_residual": torch.sqrt(torch.stack([t.to(devs[0]) for t in sq])).mean(),
            "tau": torch.tensor(tau, dtype=f32),
            "gamma": torch.tensor(float(gamma), dtype=f32),
        }
        return new_state, metrics

    @torch.no_grad()
    def load_served(self, state: dict) -> None:
        """Copy z, the served parameters, into the model."""
        for n, p in self.model.named_parameters():
            p.copy_(state["z"][n])
