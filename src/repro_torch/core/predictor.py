"""The LPRS offline latency predictor (§3.2.1, Tables 7/8): the port of
``repro/core/predictor.py``.

Three-layer MLP (128, 64, 32), ReLU, dropout 0.1, trained with AdamW under a
bucket-weighted asymmetric Huber loss: underestimating latency is penalized
harder than overestimating (underestimates cause budget overflow online).

Features are standardized with training-set statistics in float64 numpy and
cast to float32 for the network, as in the reference; data is bucketed by
scheduled_tokens and overrepresented full-chunk buckets are downsampled
(§3.2.1 step 3).  ``state_dict()`` keeps the reference's format -- ``{"params":
{"w0", "b0", ...}, "mean", "std", "y_scale", "cfg"}`` with each ``w_i`` of
shape ``(in, out)`` -- so a predictor trained by either package loads in the
other.

The network lives on an explicit ``device``.  The scheduler calls
``predict()`` on the host while it plans the next round; the serve path
builds the predictor on ``"cpu"`` for that reason (see
``repro_torch.launch.serve.train_predictor``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.features import N_FEATURES


@dataclass(frozen=True)
class PredictorConfig:
    hidden_sizes: Tuple[int, ...] = (128, 64, 32)
    dropout: float = 0.1
    epochs: int = 300
    lr: float = 2e-3
    weight_decay: float = 1e-3
    batch_size: int = 256
    # asymmetric Huber (Eq. 5)
    huber_delta: float = 5.0        # ms (or log-units * 100 when log_target)
    under_weight: float = 2.0       # penalty multiplier when y_hat < y
    over_weight: float = 1.0
    # optional: regress log-latency (False = paper-exact).  With the linear
    # cost structure the direct target trains better; log helps only when
    # the latency function is multiplicative.
    log_target: bool = False
    seed: int = 0


class MLP(nn.Module):
    """``sizes[0] -> ... -> sizes[-1]`` linear layers with ReLU between them;
    inverted dropout after each hidden ReLU when a generator is given."""

    def __init__(self, sizes: Tuple[int, ...], dropout: float):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.dropout = dropout

    def forward(self, x, dropout_gen: Optional[torch.Generator] = None):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
                if self.dropout > 0.0 and dropout_gen is not None:
                    keep = torch.rand(x.shape, generator=dropout_gen,
                                      device=x.device) < 1.0 - self.dropout
                    x = torch.where(keep, x / (1.0 - self.dropout), 0.0)
        return x[..., 0]


def init_mlp(cfg: PredictorConfig, device, n_in: int = N_FEATURES) -> MLP:
    """He-normal weights (std sqrt(2 / fan_in)) and zero biases, as the
    reference's ``init_mlp``; drawn from a CPU generator seeded with
    ``cfg.seed`` (the draws differ from ``jax.random``'s)."""
    sizes = (n_in,) + tuple(cfg.hidden_sizes) + (1,)
    mlp = MLP(sizes, cfg.dropout)
    gen = torch.Generator().manual_seed(cfg.seed)
    with torch.no_grad():
        for lin in mlp.layers:
            fan_in = lin.in_features
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen)
                             * np.sqrt(2.0 / fan_in))
            lin.bias.zero_()
    return mlp.to(device)


def asymmetric_huber(y, y_hat, delta: float, w_under: float, w_over: float):
    """Huber base with heavier penalty on underestimation (y_hat < y)."""
    err = y_hat - y
    a = err.abs()
    base = torch.where(a <= delta, 0.5 * a * a, delta * (a - 0.5 * delta))
    side = torch.where(err < 0, w_under, w_over)
    return side * base


class LatencyPredictor:
    """Trained predictor with feature standardization baked in."""

    def __init__(self, cfg: Optional[PredictorConfig] = None, *,
                 device="cuda"):
        # imported here: the engine imports this package
        from repro_torch.engine.engine import resolve_device

        self.cfg = cfg or PredictorConfig()
        self.device = resolve_device(device)
        self.mlp: Optional[MLP] = None
        self.mean = np.zeros(N_FEATURES)
        self.std = np.ones(N_FEATURES)
        self.y_scale = 1.0

    # -- inference ----------------------------------------------------------
    def predict(self, features: np.ndarray) -> np.ndarray:
        """features: (16,) or (n, 16) -> predicted latency (ms), same leading
        shape."""
        assert self.mlp is not None, "predictor not trained/loaded"
        x = np.atleast_2d(np.asarray(features, np.float64))
        xs = (x - self.mean) / self.std
        with torch.no_grad():
            out = self.mlp(torch.as_tensor(xs.astype(np.float32),
                                           device=self.device))
        out = out.cpu().numpy().astype(np.float64) * self.y_scale
        if self.cfg.log_target:
            out = np.expm1(np.clip(out, -30.0, 30.0))
        return out if features.ndim > 1 else float(out[0])

    # -- training ------------------------------------------------------------
    def fit(
        self,
        features: np.ndarray,      # (N, 16)
        latencies: np.ndarray,     # (N,) ms
        *,
        sample_weights: Optional[np.ndarray] = None,
        epochs: Optional[int] = None,
        verbose: bool = False,
    ) -> Dict[str, float]:
        cfg = self.cfg
        dev = self.device
        N = features.shape[0]
        self.mean = features.mean(axis=0)
        self.std = features.std(axis=0) + 1e-9
        targets = np.log1p(latencies) if cfg.log_target else latencies
        self.y_scale = float(np.std(targets) + 1e-9)
        x = torch.as_tensor(
            ((features - self.mean) / self.std).astype(np.float32), device=dev)
        y = torch.as_tensor((targets / self.y_scale).astype(np.float32),
                            device=dev)
        w = torch.as_tensor(
            (sample_weights if sample_weights is not None
             else np.ones(N)).astype(np.float32), device=dev)

        mlp = init_mlp(cfg, dev)
        # decoupled weight decay on every parameter, as the reference's
        # AdamW: p * (1 - lr * wd) - lr * m_hat / (sqrt(v_hat) + eps)
        opt = torch.optim.AdamW(mlp.parameters(), lr=cfg.lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay)
        delta = (cfg.huber_delta / 100.0 if cfg.log_target
                 else cfg.huber_delta) / self.y_scale
        dropout_gen = torch.Generator(device=dev).manual_seed(cfg.seed)

        n_epochs = epochs or cfg.epochs
        bs = min(cfg.batch_size, N)
        rng_np = np.random.default_rng(cfg.seed)
        last = torch.zeros(())
        mlp.train()
        for ep in range(n_epochs):
            perm = rng_np.permutation(N)
            for s in range(0, N - bs + 1, bs):
                idx = torch.as_tensor(perm[s:s + bs], device=dev)
                xb, yb, wb = x[idx], y[idx], w[idx]
                pred = mlp(xb, dropout_gen=dropout_gen)
                l = asymmetric_huber(yb, pred, delta, cfg.under_weight,
                                     cfg.over_weight)
                loss = (wb * l).sum() / wb.sum().clamp(min=1e-9)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                last = loss.detach()
            if verbose and (ep % 50 == 0 or ep == n_epochs - 1):
                print(f"  epoch {ep:4d} loss={float(last):.5f}")
        mlp.eval()
        self.mlp = mlp
        return {"final_loss": float(last)}

    # -- evaluation (Table 8 metrics) -------------------------------------------
    def evaluate(self, features: np.ndarray, latencies: np.ndarray) -> Dict[str, float]:
        pred = self.predict(features)
        err = pred - latencies
        abs_err = np.abs(err)
        mape = float(np.mean(np.abs(err / np.maximum(np.abs(latencies), 1e-9)))) * 100
        return {
            "mae_ms": float(abs_err.mean()),
            "rmse_ms": float(np.sqrt((err ** 2).mean())),
            "mape_pct": mape,
            "p50_ms": float(np.percentile(abs_err, 50)),
            "p90_ms": float(np.percentile(abs_err, 90)),
            "p95_ms": float(np.percentile(abs_err, 95)),
            "p99_ms": float(np.percentile(abs_err, 99)),
            "within_5ms_pct": float((abs_err <= 5.0).mean() * 100),
            "within_10ms_pct": float((abs_err <= 10.0).mean() * 100),
        }

    # -- persistence -----------------------------------------------------------
    def state_dict(self) -> Dict:
        """The reference's format: ``params`` as numpy float32 ``w_i (in,
        out)`` (``nn.Linear.weight`` transposed) and ``b_i (out,)``."""
        params = {}
        for i, lin in enumerate(self.mlp.layers):
            params[f"w{i}"] = lin.weight.detach().cpu().numpy().T.copy()
            params[f"b{i}"] = lin.bias.detach().cpu().numpy().copy()
        return {
            "params": params,
            "mean": self.mean,
            "std": self.std,
            "y_scale": self.y_scale,
            "cfg": dataclasses.asdict(self.cfg),
        }

    @classmethod
    def from_state(cls, state: Dict, *, device="cuda") -> "LatencyPredictor":
        """Load a ``state_dict()`` of this class or of the reference's."""
        cfg = PredictorConfig(**{
            k: tuple(v) if k == "hidden_sizes" else v for k, v in state["cfg"].items()
        })
        p = cls(cfg, device=device)
        params = state["params"]
        mlp = MLP((np.shape(params["w0"])[0],) + tuple(cfg.hidden_sizes) + (1,),
                  cfg.dropout)
        with torch.no_grad():
            for i, lin in enumerate(mlp.layers):
                lin.weight.copy_(torch.tensor(
                    np.asarray(params[f"w{i}"], np.float32).T))
                lin.bias.copy_(torch.tensor(
                    np.asarray(params[f"b{i}"], np.float32)))
        p.mlp = mlp.to(p.device).eval()
        p.mean = np.asarray(state["mean"])
        p.std = np.asarray(state["std"])
        p.y_scale = float(state["y_scale"])
        return p


class AnalyticPredictor:
    """Closed-form fallback/oracle predictor (linear cost model).  Used for
    tests and as the simulator's ground truth generator."""

    def __init__(self, c0=2.0, c_prefill=0.04, c_decode=0.06, c_ctx=2e-5, c_batch=0.05):
        self.c = (c0, c_prefill, c_decode, c_ctx, c_batch)

    def predict(self, features: np.ndarray) -> np.ndarray:
        f = np.atleast_2d(np.asarray(features, np.float64))
        c0, cp, cd, cc, cb = self.c
        out = c0 + cp * f[..., 0] + cd * f[..., 1] + cc * f[..., 3] + cb * f[..., 2]
        return out if np.asarray(features).ndim > 1 else float(out[0])


def bucket_and_downsample(
    scheduled_tokens: np.ndarray,
    *,
    n_buckets: int = 16,
    max_bucket_frac: float = 0.25,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """§3.2.1 step 3: bucket samples by total scheduled tokens, downsample
    overrepresented (full-chunk) buckets.  Returns (keep_idx, weights)."""
    st = np.asarray(scheduled_tokens, np.float64)
    N = len(st)
    edges = np.quantile(st, np.linspace(0, 1, n_buckets + 1))
    edges[-1] += 1
    bucket = np.clip(np.searchsorted(edges, st, side="right") - 1, 0, n_buckets - 1)
    rng = np.random.default_rng(seed)
    keep = np.ones(N, bool)
    cap = int(max_bucket_frac * N)
    for b in range(n_buckets):
        idx = np.where(bucket == b)[0]
        if len(idx) > cap:
            drop = rng.choice(idx, size=len(idx) - cap, replace=False)
            keep[drop] = False
    kept = np.where(keep)[0]
    # bucket-aware weights: inverse sqrt frequency of the kept distribution
    kb = bucket[kept]
    counts = np.bincount(kb, minlength=n_buckets).astype(np.float64)
    wts = 1.0 / np.sqrt(np.maximum(counts[kb], 1.0))
    wts *= len(kept) / wts.sum()
    return kept, wts
