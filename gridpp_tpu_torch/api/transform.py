"""Transform hierarchy (gridpp_tpu/api/transform.py; reference
src/api/transform.cpp, gridpp.h:2345-2452).

Identity, Log, BoxCox, StartedBoxCox, Gamma. forward/backward take scalars
or arrays of any rank and keep their shape; NaN propagates (the
reference's is_valid guards). forward/backward are numpy (thin pre- and
post-processing steps, Gamma on scipy.special); `forward_tensor` and
`backward_tensor` give the same maps on tensors, on the tensor's device
(torch.special for Gamma). Gamma's backward has no tensor form (torch has
no inverse incomplete gamma): it takes a CPU tensor through numpy and
raises for any other.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Transform", "Identity", "Log", "BoxCox", "StartedBoxCox", "Gamma"]


class Transform:
    def forward(self, value):
        scalar = np.ndim(value) == 0
        arr = np.asarray(value, dtype=np.float32)
        out = self._forward(arr)
        return float(out) if scalar else out.astype(np.float32)

    def backward(self, value):
        scalar = np.ndim(value) == 0
        arr = np.asarray(value, dtype=np.float32)
        out = self._backward(arr)
        return float(out) if scalar else out.astype(np.float32)

    def _forward(self, arr):
        raise NotImplementedError

    def _backward(self, arr):
        raise NotImplementedError

    def forward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        return self._host_tensor(self._forward, x)

    def backward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        return self._host_tensor(self._backward, x)

    def _host_tensor(self, fn, x):
        """fn through numpy, for a CPU tensor only: a transform without a
        tensor form never moves a device tensor to the host."""
        if x.device.type != "cpu":
            raise NotImplementedError(
                f"{type(self).__name__} has no tensor form on {x.device}")
        return torch.from_numpy(
            np.asarray(fn(x.numpy()), np.float32).copy())


class Identity(Transform):
    def _forward(self, arr):
        return arr

    def _backward(self, arr):
        return arr

    def forward_tensor(self, x):
        return x

    def backward_tensor(self, x):
        return x


class Log(Transform):
    """log/exp (transform.cpp:85-96)."""

    def _forward(self, arr):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.log(arr)

    def _backward(self, arr):
        return np.exp(arr)

    def forward_tensor(self, x):
        return torch.log(x)

    def backward_tensor(self, x):
        return torch.exp(x)


class BoxCox(Transform):
    """Box-Cox with parameter lambda (transform.cpp:97-125).

    forward clamps values <= 0 to 0; backward floors the argument at
    -1/lambda and clamps negative results to 0.
    """

    def __init__(self, threshold):
        self.threshold = float(threshold)

    def _forward(self, arr):
        lam = self.threshold
        v = np.maximum(arr, 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            if lam == 0:
                return np.log(v)
            return (np.power(v, lam) - 1) / lam

    def _backward(self, arr):
        lam = self.threshold
        if lam == 0:
            return np.exp(arr)
        v = np.maximum(arr, -1.0 / lam)
        with np.errstate(invalid="ignore"):
            out = np.power(1 + lam * v, 1 / lam)
        return np.where(out <= 0, 0, out) * np.where(np.isfinite(arr), 1, np.nan)

    def forward_tensor(self, x):
        lam = self.threshold
        v = torch.clamp(x, min=0)
        if lam == 0:
            return torch.log(v)
        return (torch.pow(v, lam) - 1) / lam

    def backward_tensor(self, x):
        lam = self.threshold
        if lam == 0:
            return torch.exp(x)
        v = torch.clamp(x, min=-1.0 / lam)
        out = torch.pow(1 + lam * v, 1 / lam)
        return torch.where(out <= 0, 0.0, out) * torch.where(
            torch.isfinite(x), 1.0, torch.nan)


class StartedBoxCox(Transform):
    """Identity below `scaling_factor`, scaled Box-Cox above
    (transform.cpp:126-154)."""

    def __init__(self, threshold, scaling_factor):
        threshold = float(threshold)
        scaling_factor = float(scaling_factor)
        if not np.isfinite(threshold) or threshold <= 0:
            raise ValueError("threshold parameter must be > 0 in the started "
                             "Box-Cox distribution")
        if not np.isfinite(scaling_factor) or scaling_factor <= 0:
            raise ValueError("Scaling factor parameter must be > 0 in the "
                             "started Box-Cox distribution")
        self.threshold = threshold
        self.scaling = scaling_factor

    def _forward(self, arr):
        lam = self.threshold
        s = self.scaling
        v = np.maximum(arr, 0)
        with np.errstate(invalid="ignore"):
            trans = s * (1 + (np.power(v / s, lam) - 1) / lam)
        out = np.where(v <= s, v, trans)
        return np.where(np.isfinite(arr), out, np.nan)

    def _backward(self, arr):
        lam = self.threshold
        s = self.scaling
        with np.errstate(invalid="ignore"):
            trans = s * np.power(1 + lam / s * (arr - s), 1 / lam)
        out = np.where(arr <= s, arr, trans)
        out = np.where(out < 0, 0, out)
        return np.where(np.isfinite(arr), out, np.nan)

    def forward_tensor(self, x):
        lam = self.threshold
        s = self.scaling
        v = torch.clamp(x, min=0)
        trans = s * (1 + (torch.pow(v / s, lam) - 1) / lam)
        out = torch.where(v <= s, v, trans)
        return torch.where(torch.isfinite(x), out, torch.nan)

    def backward_tensor(self, x):
        lam = self.threshold
        s = self.scaling
        trans = s * torch.pow(1 + lam / s * (x - s), 1 / lam)
        out = torch.where(x <= s, x, trans)
        out = torch.where(out < 0, 0.0, out)
        return torch.where(torch.isfinite(x), out, torch.nan)


class Gamma(Transform):
    """Gamma CDF -> standard normal quantile (transform.cpp:155-179)."""

    def __init__(self, shape, scale, tolerance=0.01):
        shape = float(shape)
        scale = float(scale)
        tolerance = float(tolerance)
        if not np.isfinite(shape) or shape <= 0:
            raise ValueError(
                "Shape parameter must be > 0 in the gamma distribution")
        if not np.isfinite(scale) or scale <= 0:
            raise ValueError(
                "Scale parameter must be > 0 in the gamma distribution")
        if not np.isfinite(tolerance) or tolerance < 0:
            raise ValueError(
                "Tolerance must be >= 0 in the gamma distribution")
        self.shape = shape
        self.scale = scale
        self.tolerance = tolerance

    def _forward(self, arr):
        from scipy import special
        with np.errstate(invalid="ignore"):
            cdf = special.gammainc(self.shape,
                                   np.maximum(arr + self.tolerance, 0)
                                   / self.scale)
            out = special.ndtri(cdf.astype(np.float64))
        return np.where(np.isfinite(arr), out, np.nan)

    def _backward(self, arr):
        from scipy import special
        with np.errstate(invalid="ignore"):
            cdf = special.ndtr(arr.astype(np.float64))
            out = special.gammaincinv(self.shape, cdf) * self.scale \
                - self.tolerance
        return np.where(np.isfinite(arr), out, np.nan)

    def forward_tensor(self, x):
        # in double, as scipy's: an f32 cdf rounds to 1 past z ~ 5.3
        xd = x.to(torch.float64)
        cdf = torch.special.gammainc(
            torch.full_like(xd, self.shape),
            torch.clamp(xd + self.tolerance, min=0) / self.scale)
        out = torch.where(torch.isfinite(xd), torch.special.ndtri(cdf),
                          torch.nan)
        return out.to(x.dtype)
