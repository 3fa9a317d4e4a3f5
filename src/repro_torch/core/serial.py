"""Serial ADMM trainer and the backprop baselines (paper §4.1, §4.2).

The port's counterpart of ``repro.core.serial``: the global form of
Algorithm 1 on the whole graph (one community, one agent) — the paper's
'Serial ADMM' and the math oracle of the parallel trainer — and backprop
GCN training with the paper's comparison optimizers.  Both hold the dense
normalized adjacency Ã on the device and multiply by it with
``torch.matmul``, as the reference leaves those products to XLA.

``device=None`` means ``cuda`` (RuntimeError without one); tests pass
``device="cpu"``.  Weights come from a ``torch.Generator``; parity tests
inject the JAX state (``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import gcn, graph, subproblems
from repro_torch.optim import optimizers
from repro_torch.util.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainLog:
    epoch: list = dataclasses.field(default_factory=list)
    train_acc: list = dataclasses.field(default_factory=list)
    test_acc: list = dataclasses.field(default_factory=list)
    lagrangian: list = dataclasses.field(default_factory=list)
    residual: list = dataclasses.field(default_factory=list)
    epoch_time_s: list = dataclasses.field(default_factory=list)

    def as_dict(self):
        return dataclasses.asdict(self)


class _GraphTensors:
    """Ã, features, labels and masks of ``g`` on ``device``."""

    def __init__(self, g: graph.Graph, device: "str | torch.device | None"):
        self.device = device = resolve_device(device)
        self.a_tilde = torch.as_tensor(
            graph.normalized_adjacency(g.num_nodes, g.edges), device=device)
        self.z0 = torch.as_tensor(g.features, device=device)
        self.labels = torch.as_tensor(g.labels, device=device)
        self.train_mask = torch.as_tensor(g.train_mask, dtype=torch.float32,
                                          device=device)
        self.test_mask = torch.as_tensor(g.test_mask, dtype=torch.float32,
                                         device=device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class SerialADMMTrainer(_GraphTensors):
    """Single-agent ADMM GCN trainer (the paper's 'Serial ADMM')."""

    def __init__(self, cfg: gcn.GCNConfig, admm: subproblems.ADMMConfig,
                 g: graph.Graph, seed: int = 0,
                 device: "str | torch.device | None" = None):
        super().__init__(g, device)
        self.cfg, self.admm, self.graph = cfg, admm, g
        self.state = subproblems.init_state(
            cfg, admm, self.a_tilde, self.z0,
            torch.Generator().manual_seed(seed))

    def next_state(self, state: "subproblems.ADMMState | None" = None
                   ) -> subproblems.ADMMState:
        """One ADMM iteration from ``state`` (default: the current state)
        without changing the trainer."""
        state = self.state if state is None else state
        return subproblems.admm_iteration(self.cfg, self.admm, self.a_tilde,
                                          self.z0, self.labels,
                                          self.train_mask, state)

    def step(self) -> None:
        self.state = self.next_state()

    @torch.no_grad()
    def _metrics(self, state: subproblems.ADMMState):
        """(train accuracy, test accuracy, ‖Z_L − Ã Z_{L-1} W_L‖)."""
        cfg = self.cfg
        logits = gcn.forward(cfg, self.a_tilde, self.z0, state.weights)[-1]
        z_pen = state.zs[-2] if cfg.num_layers >= 2 else self.z0
        res = state.zs[-1] - self.a_tilde @ z_pen @ state.weights[-1]
        return (gcn.accuracy(logits, self.labels, self.train_mask),
                gcn.accuracy(logits, self.labels, self.test_mask),
                torch.linalg.norm(res))

    def _lagrangian(self, state: subproblems.ADMMState) -> Tensor:
        return subproblems.lagrangian_value(self.cfg, self.admm,
                                            self.a_tilde, self.z0,
                                            self.labels, self.train_mask,
                                            state)

    def train(self, epochs: int, log_every: int = 1,
              verbose: bool = False) -> TrainLog:
        log = TrainLog()
        for epoch in range(epochs):
            self._sync()
            t0 = time.perf_counter()
            self.step()
            self._sync()
            dt = time.perf_counter() - t0
            if epoch % log_every == 0 or epoch == epochs - 1:
                tr, te, res = self._metrics(self.state)
                lag = self._lagrangian(self.state)
                log.epoch.append(epoch)
                log.train_acc.append(float(tr))
                log.test_acc.append(float(te))
                log.lagrangian.append(float(lag))
                log.residual.append(float(res))
                log.epoch_time_s.append(dt)
                if verbose:
                    print(f"[serial-admm] epoch {epoch:3d} train {tr:.3f} "
                          f"test {te:.3f} lagr {lag:.4f} res {res:.3e} "
                          f"({dt*1e3:.1f} ms)")
        return log


# ---------------------------------------------------------------------------
# SGD-family baselines (paper §4.2 comparison methods)
# ---------------------------------------------------------------------------

class BaselineTrainer(_GraphTensors):
    """Backprop GCN training with the paper's comparison optimizers."""

    def __init__(self, cfg: gcn.GCNConfig, g: graph.Graph, optimizer: str,
                 lr: float, seed: int = 0,
                 device: "str | torch.device | None" = None):
        super().__init__(g, device)
        self.cfg, self.graph = cfg, g
        self.weights = tuple(gcn.init_weights(
            cfg, torch.Generator().manual_seed(seed), self.device))
        self.opt = optimizers.make(optimizer, lr)
        self.opt_state = self.opt.init(self.weights)

    def _step(self, weights, opt_state):
        """(weights + update, optimizer state, loss at ``weights``)."""
        with torch.enable_grad():
            ws = [w.detach().requires_grad_(True) for w in weights]
            loss = gcn.loss_fn(self.cfg, self.a_tilde, self.z0, ws,
                               self.labels, self.train_mask)
            grads = torch.autograd.grad(loss, ws)
        with torch.no_grad():
            updates, opt_state = self.opt.update(grads, opt_state, weights)
            weights = tuple(w + u for w, u in zip(weights, updates))
        return weights, opt_state, loss.detach()

    @torch.no_grad()
    def _metrics(self, weights):
        logits = gcn.forward(self.cfg, self.a_tilde, self.z0, weights)[-1]
        return (gcn.accuracy(logits, self.labels, self.train_mask),
                gcn.accuracy(logits, self.labels, self.test_mask))

    def train(self, epochs: int, verbose: bool = False) -> TrainLog:
        log = TrainLog()
        for epoch in range(epochs):
            self._sync()
            t0 = time.perf_counter()
            self.weights, self.opt_state, loss = self._step(
                self.weights, self.opt_state)
            self._sync()
            dt = time.perf_counter() - t0
            tr, te = self._metrics(self.weights)
            log.epoch.append(epoch)
            log.train_acc.append(float(tr))
            log.test_acc.append(float(te))
            log.lagrangian.append(float(loss))
            log.residual.append(0.0)
            log.epoch_time_s.append(dt)
            if verbose:
                print(f"[baseline] epoch {epoch:3d} loss {loss:.4f} "
                      f"train {tr:.3f} test {te:.3f}")
        return log
