"""The paper's application models (Sec. 6.2-6.4) in PyTorch: kNN
classification, linear regression, multinomial Naive Bayes. Each is
(re)trained on a realized sample given as fixed-capacity tensors plus a
validity mask.

Matrix products and the small solve stay with torch (the JAX package leaves
them to XLA). Nothing here syncs to the host: one-hot encodings are
comparisons (``F.one_hot`` checks its input on the host) and the solve is
``solve_ex`` (``solve`` reads its error flag back). Callers on the card set
``torch.backends.cuda.matmul.allow_tf32 = False`` so the f32 products run
in full f32, as on the CPU.
"""
from __future__ import annotations

import torch

_F32 = torch.float32


def _one_hot(y: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot; out-of-range labels give a zero row, as in JAX."""
    cls = torch.arange(num_classes, device=y.device)
    return (y.to(torch.int64).unsqueeze(-1) == cls).to(_F32)


def knn_predict(train_x, train_y, valid, query_x, *, k: int = 7,
                num_classes: int = 100) -> torch.Tensor:
    """Majority vote over the k nearest (Euclidean) valid training points."""
    d2 = torch.sum((query_x[:, None, :] - train_x[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(valid[None, :], d2, torch.inf)
    _, idx = torch.topk(-d2, k, dim=-1)                  # [Q, k]
    votes = train_y[idx]
    # neighbours that are invalid (tiny samples) carry no vote
    ok = torch.gather(valid[None].expand(d2.shape), 1, idx)
    onehot = _one_hot(votes, num_classes) * ok.unsqueeze(-1).to(_F32)
    return torch.argmax(onehot.sum(dim=1), dim=-1).to(torch.int32)


def linreg_fit(train_x, train_y, valid) -> torch.Tensor:
    """Least squares (with intercept) over the valid rows, closed form."""
    w = valid.to(_F32)
    X = torch.cat([train_x, torch.ones_like(train_x[:, :1])], dim=1)
    Xw = X * w[:, None]
    A = Xw.T @ X + 1e-6 * torch.eye(X.shape[1], dtype=_F32, device=X.device)
    b = Xw.T @ train_y
    return torch.linalg.solve_ex(A, b)[0]


def linreg_predict(coef, query_x) -> torch.Tensor:
    X = torch.cat([query_x, torch.ones_like(query_x[:, :1])], dim=1)
    return X @ coef


def nb_fit(train_counts, train_y, valid, *, num_classes: int = 2):
    """Multinomial Naive Bayes with Laplace smoothing over bag-of-words."""
    w = valid.to(_F32)
    onehot = _one_hot(train_y, num_classes) * w[:, None]        # [N, C]
    class_counts = onehot.sum(dim=0)                            # [C]
    word_counts = onehot.T @ train_counts                       # [C, V]
    log_prior = torch.log(class_counts + 1.0) - torch.log(
        torch.sum(class_counts) + num_classes)
    log_like = torch.log(word_counts + 1.0) - torch.log(
        word_counts.sum(dim=1, keepdim=True) + train_counts.shape[1])
    return log_prior, log_like


def nb_predict(params, query_counts) -> torch.Tensor:
    log_prior, log_like = params
    scores = query_counts @ log_like.T + log_prior[None]
    return torch.argmax(scores, dim=-1).to(torch.int32)


def expected_shortfall(values, frac: float) -> float:
    """z% ES: the mean of the worst ``max(1, round(frac n))`` of ``n``
    values, largest first (paper Sec. 6.2, [27]); on the host, in numpy."""
    import numpy as np

    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    v = np.sort(np.asarray(values))[::-1]   # worst (largest error) first
    k = max(1, int(round(frac * len(v))))
    return float(v[:k].mean())
