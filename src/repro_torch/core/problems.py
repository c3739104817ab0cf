"""Convex finite-sum problems of the paper's experiments (the port of
``repro.core.problems``), in float64 on the caller's device.

``FiniteSumProblem`` models ``f(x) = (1/n) sum_i f_i(x)`` with per-client
data: l2-regularized logistic regression (paper eq. 20) and heterogeneous
quadratics.  The data is drawn on the host with the reference's numpy calls
in the reference's order, so it is the reference's bit for bit, then moved
to the device.  Every tensor is float64 by explicit ``dtype``; the process
default type is never changed.

Three places differ in method, not in result:

* the smoothness constant ``L_i = lambda_max(A_i^T A_i) / (4 m)`` comes from
  the ``m x m`` Gram ``A_i A_i^T`` (same nonzero spectrum), batched on the
  device, instead of a ``d x d`` eigensolve per client;
* Newton's method for ``x*`` solves with the ``(n m) x (n m)`` sample Gram
  (Woodbury) when there are fewer samples than coordinates, else with the
  ``d x d`` Hessian, as the reference does;
* the logistic loss is ``logaddexp(-z, 0)``, which is ``jax.nn.softplus``;
  ``torch.nn.functional.softplus`` returns its argument above a threshold.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels.ref import _div

F64 = torch.float64


@dataclass(kw_only=True)
class FiniteSumProblem:
    """A finite-sum convex problem split across ``n`` clients.

    ``cohort_data(cohort)`` gathers the per-client data of a cohort (all
    clients for ``None``) once; ``grads(X, data)`` is then the ``(c, d)``
    per-client gradients at per-client models ``X``, the O(c d) oracle a
    TAMUNA local step needs."""

    n: int
    d: int
    mu: float
    L: float
    x_star: Optional[torch.Tensor] = None
    f_star: Optional[float] = None
    name: str = "problem"
    meta: dict = field(default_factory=dict)

    @property
    def kappa(self) -> float:
        return self.L / self.mu

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def f(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def cohort_data(self, cohort: Optional[torch.Tensor]) -> Tuple:
        raise NotImplementedError

    def grads(self, X: torch.Tensor, data: Tuple) -> torch.Tensor:
        raise NotImplementedError

    def grad_cohort(self, X: torch.Tensor,
                    cohort: torch.Tensor) -> torch.Tensor:
        return self.grads(X, self.cohort_data(cohort))

    def grad_all_local(self, X: torch.Tensor) -> torch.Tensor:
        return self.grads(X, self.cohort_data(None))

    def grad_all(self, x: torch.Tensor) -> torch.Tensor:
        return self.grad_all_local(x.expand(self.n, self.d))

    def grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.grad_all(x).mean(dim=0)

    def suboptimality(self, x: torch.Tensor) -> torch.Tensor:
        return self.f(x) - self.f_star

    def h_star(self) -> torch.Tensor:
        """Per-client optimal control variates ``h_i* = grad f_i(x*)``."""
        return self.grad_all(self.x_star)

    def to(self, device: DeviceLike) -> "FiniteSumProblem":
        """A copy with every tensor on ``device``."""
        dev = resolve_device(device)
        moved = {f.name: getattr(self, f.name).to(dev)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


@dataclass(kw_only=True)
class LogRegProblem(FiniteSumProblem):
    """``f_i(x) = mean_m softplus(-b_im a_im . x) + mu/2 ||x||^2``."""

    A: torch.Tensor  # (n, m, d) features
    b: torch.Tensor  # (n, m) labels in {-1, +1}

    @property
    def device(self) -> torch.device:
        return self.A.device

    def f(self, x: torch.Tensor) -> torch.Tensor:
        z = (self.A.reshape(-1, self.d) @ x) * self.b.reshape(-1)
        return (torch.logaddexp(-z, torch.zeros_like(z)).mean()
                + 0.5 * self.mu * torch.sum(x * x))

    def cohort_data(self, cohort):
        if cohort is None:
            return self.A, self.b
        return self.A[cohort], self.b[cohort]

    def grads(self, X, data):
        A, b = data
        z = torch.bmm(A, X[:, :, None])[..., 0] * b
        coef = b * torch.sigmoid(-z)
        return (-_div(torch.bmm(coef[:, None, :], A)[:, 0, :], A.shape[1])
                + self.mu * X)


@dataclass(kw_only=True)
class QuadraticProblem(FiniteSumProblem):
    """``f_i(x) = 1/2 x^T D x - t_i^T x`` with a shared diagonal ``D``."""

    diag: torch.Tensor  # (d,)
    t: torch.Tensor  # (n, d) client targets

    @property
    def device(self) -> torch.device:
        return self.t.device

    def f(self, x: torch.Tensor) -> torch.Tensor:
        per = 0.5 * torch.sum(self.diag * x * x) - self.t @ x
        return per.mean()

    def cohort_data(self, cohort):
        return (self.t,) if cohort is None else (self.t[cohort],)

    def grads(self, X, data):
        return X * self.diag[None, :] - data[0]


def logreg_data(n: int, d: int, m: int, seed: int,
                heterogeneity: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's synthetic features ``A (n, m, d)`` and labels
    ``b (n, m)``: the same numpy draws in the same order."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n, 1, d)) * heterogeneity
    A = rng.normal(size=(n, m, d)) + centers
    w_true = rng.normal(size=(d,))
    logits = (A @ w_true) + 0.5 * rng.normal(size=(n, m))
    b = np.sign(logits).astype(np.float64)
    b[b == 0] = 1.0
    return A, b


def smoothness(A: torch.Tensor) -> float:
    """``max_i lambda_max(A_i^T A_i) / (4 m)`` from the batched ``m x m``
    Grams ``A_i A_i^T``."""
    m = A.shape[1]
    lam = torch.linalg.eigvalsh(torch.bmm(A, A.transpose(1, 2)))
    return float((lam.amax(dim=1) / (4.0 * m)).max())


def make_logreg_problem(*, n: int = 64, d: int = 300,
                        samples_per_client: int = 16, kappa: float = 1e4,
                        seed: int = 0, heterogeneity: float = 1.0,
                        name: str = "logreg",
                        device: DeviceLike = "cuda") -> LogRegProblem:
    """Synthetic l2-regularized logistic regression with ``kappa = L/mu``
    prescribed and heterogeneous shards; ``x*`` by Newton's method."""
    dev = resolve_device(device)
    m = samples_per_client
    t0 = time.perf_counter()
    A_np, b_np = logreg_data(n, d, m, seed, heterogeneity)
    A = torch.tensor(A_np, dtype=F64, device=dev)
    b = torch.tensor(b_np, dtype=F64, device=dev)
    del A_np, b_np
    t1 = time.perf_counter()
    L_data = smoothness(A)  # a host float: waits for the device
    mu = L_data / (kappa - 1.0)
    L = L_data + mu
    t2 = time.perf_counter()
    prob = LogRegProblem(
        n=n, d=d, mu=float(mu), L=float(L), A=A, b=b, name=name,
        meta=dict(samples_per_client=m, kappa=kappa, seed=seed))
    prob.meta["newton_iters"] = solve_exactly(prob, A.reshape(n * m, d),
                                              b.reshape(-1), mu)
    # host seconds of the set-up: data (drawn and moved), L, Newton
    prob.meta["setup_s"] = dict(data=t1 - t0, L=t2 - t1,
                                newton=time.perf_counter() - t2)
    return prob


def make_quadratic_problem(*, n: int = 32, d: int = 64, kappa: float = 100.0,
                           seed: int = 0, name: str = "quadratic",
                           device: DeviceLike = "cuda") -> QuadraticProblem:
    """Heterogeneous strongly convex quadratics with the closed-form
    ``x* = D^{-1} mean(t_i)`` (computed in numpy, as the reference does)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    mu, L = 1.0, float(kappa)
    diag = np.linspace(mu, L, d)
    t = rng.normal(size=(n, d)) * 5.0
    x_star = t.mean(axis=0) / diag
    prob = QuadraticProblem(
        n=n, d=d, mu=mu, L=L, diag=torch.tensor(diag, dtype=F64, device=dev),
        t=torch.tensor(t, dtype=F64, device=dev),
        x_star=torch.tensor(x_star, dtype=F64, device=dev), name=name,
        meta=dict(kappa=kappa))
    prob.f_star = float(prob.f(prob.x_star))
    return prob


def solve_exactly(prob: LogRegProblem, A: torch.Tensor, b: torch.Tensor,
                  mu: float, tol: float = 1e-14, max_iter: int = 200) -> int:
    """Newton's method to machine precision on ``A (M, d)``, ``b (M,)``;
    fills ``x_star`` / ``f_star`` and returns the number of steps.  The Hessian is ``H = A^T W A / M + mu
    I``; with ``M < d`` the step solves ``mu I + B B^T`` (``B = W^(1/2) A /
    sqrt(M)``, Woodbury) over the ``M x M`` Gram ``A A^T`` formed once."""
    M, d = A.shape
    x = torch.zeros(d, dtype=F64, device=A.device)
    eye = torch.eye(min(M, d), dtype=F64, device=A.device)
    gram = A @ A.T if M < d else None
    for it in range(1, max_iter + 1):
        z = (A @ x) * b
        sig = 1.0 / (1.0 + torch.exp(z))  # sigmoid(-z)
        g = -_div(A.T @ (b * sig), M) + mu * x
        w = sig * (1.0 - sig)
        if gram is None:
            H = _div((A.T * w) @ A, M) + mu * eye
            step = torch.linalg.solve(H, g)
        else:
            u = torch.sqrt(_div(w, M))
            K = mu * eye + u[:, None] * gram * u[None, :]
            y = torch.linalg.solve(K, u * (A @ g))
            step = _div(g - A.T @ (u * y), mu)
        x = x - step
        if torch.linalg.vector_norm(g) < tol:
            break
    prob.x_star = x
    prob.f_star = float(prob.f(x))
    return it
