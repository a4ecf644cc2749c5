"""Cross-chain MCMC diagnostics: split R-hat and effective sample size.

Port of ``bayesian_coresets_tpu/mcmc/diagnostics.py``: the standard
split-R-hat and autocorrelation-ESS definitions (Vehtari et al. 2021), with
the autocovariance from ``torch.fft``.
"""

from __future__ import annotations

import torch


def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """samples: (chains, draws, d) -> (d,) split-R-hat."""
    c, n, d = samples.shape
    half = n // 2
    x = samples[:, : 2 * half, :].reshape(c * 2, half, d)
    chain_mean = x.mean(dim=1)                            # (m, d)
    chain_var = x.var(dim=1, correction=1)                # (m, d)
    between = half * chain_mean.var(dim=0, correction=1)  # (d,)
    within = chain_var.mean(dim=0)                        # (d,)
    var_est = (half - 1) / half * within + between / half
    return torch.sqrt(var_est / within)


def ess(samples: torch.Tensor, max_lag: int | None = None) -> torch.Tensor:
    """samples: (chains, draws, d) -> (d,) bulk effective sample size."""
    c, n, d = samples.shape
    if max_lag is None:
        max_lag = min(n - 1, 1000)
    x = samples - samples.mean(dim=1, keepdim=True)
    # FFT autocovariance per chain and dimension
    nfft = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(x, n=nfft, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=1)[:, :n, :] / n
    acov = acov.mean(dim=0)                               # (n, d) chain-averaged
    var = acov[0]
    rho = acov[:max_lag] / torch.where(var > 0, var, 1.0)
    # Geyer initial positive sequence on paired sums
    even = rho[0::2][: max_lag // 2]
    odd = rho[1::2][: max_lag // 2]
    pair = even + odd
    pos = torch.cumprod((pair > 0).to(pair.dtype), dim=0)
    tau = -1.0 + 2.0 * torch.sum(pair * pos, dim=0)
    return c * n / torch.clamp(tau, min=1.0 / (c * n))
