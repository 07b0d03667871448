"""Wrappers of the fused front-end kernels: the FFT route
(``csrc/fbank_fft_kernel.cu``).

:func:`audio_features` takes raw f32 PCM ``(B, S)``, ``cfg.preemph`` and
optional per-row ``sample_lengths``, and returns ``(B, T, D)`` fbank,
logfbank or MFCC features: the port of ``deeplip_tpu/ops/pallas/
fbank_kernel.py``'s ``pallas_audio_features`` (its v2 and v1 Pallas kernels
both), with the pre-emphasis and the length mask of ``extract_features``
folded in. On a CUDA tensor it launches one kernel on the current stream,
or raises; on a CPU tensor it runs the plain version,
:func:`audio_features_reference`.

The rule between the kernels (:func:`front_end_kernel`): every ``n_fft``
from 64 to 4096 (``FFT_SIZES``) takes the FFT route, a power of two
through the FFT kernel's compile-time radix-16 plan
(:func:`fft_audio_features`), any other through its mixed-radix and
Bluestein plan (:func:`mixed_fft_audio_features`); no kernel takes an ``n_fft``
outside that range, and a CUDA batch at one is refused. Both plans
take every ``frame_len <= n_fft``.

The kernels' constants (FFT twiddles, Bluestein's chirp and its filter, the
mel filterbank per filter, the DCT and the lifter) are made in float64 from
``ops.spectral``, cast to f32 and uploaded once per device and config.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import numpy as np
import torch

from deeplip_tpu_torch.ops import features as F
from deeplip_tpu_torch.ops import framing, spectral
from deeplip_tpu_torch.ops.cuda import build

_FEAT_CODES = {"fbank": 0, "logfbank": 1, "mfcc": 2}
FFT_SIZES = (64, 4096)   # the FFT route's smallest and largest n_fft
ODD_RADICES = (3, 5, 7)  # the mixed-radix passes' odd radices


def front_end_kernel(cfg: F.FeatureConfig) -> str:
    """Which kernel a CUDA batch at ``cfg`` launches: ``"fft"`` (a power of
    two in ``FFT_SIZES``), ``"mixed"`` (any other size there) or none,
    ``"plain"`` (an ``n_fft`` outside ``FFT_SIZES``, which only a CPU batch
    takes, through the plain version)."""
    n = cfg.n_fft
    if not FFT_SIZES[0] <= n <= FFT_SIZES[1]:
        return "plain"
    return "fft" if n & (n - 1) == 0 else "mixed"


# ------------------------------------------------ the FFT route's plan
@dataclasses.dataclass(frozen=True)
class FftPlan:
    """How the FFT route transforms one ``n_fft``-point frame.

    An even ``n_fft`` packs ``z[n] = e[2n] + i e[2n+1]`` into an ``n =
    n_fft/2``-point complex DFT and untangles the real-input bins from it;
    an odd one takes the ``n = n_fft``-point complex DFT of the real frame.
    The DFT runs as Stockham ``passes``, ``(radix, ns)`` with ``ns`` the size
    of the sub-transforms a pass combines, over ``m`` points: ``m = n`` when
    ``n`` has no prime factor above 7, else ``m`` is the least power of two
    ``>= 2n - 1`` and the DFT is Bluestein's chirp-z, a circular convolution
    of length ``m`` done by two ``m``-point transforms."""

    n_fft: int
    n: int
    m: int
    passes: tuple[tuple[int, int], ...]

    @property
    def packed(self) -> bool:
        return self.n_fft % 2 == 0

    @property
    def bluestein(self) -> bool:
        return self.m != self.n


def _radices(n: int) -> list[int] | None:
    """Radix 16 while four or more factors of 2 are left, then one pass of
    the power of two that is left (2, 4 or 8), then 3, 5 and 7 as often as
    they divide ``n``; None when a larger prime is left."""
    twos = (n & -n).bit_length() - 1
    out = [16] * (twos // 4) + ([1 << (twos % 4)] if twos % 4 else [])
    n >>= twos
    for p in ODD_RADICES:
        while n % p == 0:
            out.append(p)
            n //= p
    return out if n == 1 else None


def fft_plan(n_fft: int) -> FftPlan:
    """The FFT route's plan for ``n_fft``; raises ``ValueError`` outside
    ``FFT_SIZES``. A power of two keeps the FFT kernel's plan: radix 16,
    then one pass of 2, 4 or 8, over ``n_fft/2`` points."""
    if not FFT_SIZES[0] <= n_fft <= FFT_SIZES[1]:
        raise ValueError(f"the FFT route takes an n_fft in [{FFT_SIZES[0]}, "
                         f"{FFT_SIZES[1]}], not {n_fft}")
    n = n_fft // 2 if n_fft % 2 == 0 else n_fft
    m, radices = n, _radices(n)
    if radices is None:
        m = 1 << (2 * n - 2).bit_length()   # the least power of two >= 2n - 1
        radices = _radices(m)
    passes, ns = [], 1
    for r in radices:
        passes.append((r, ns))
        ns *= r
    return FftPlan(n_fft, n, m, tuple(passes))


def _small_plan(radix: int) -> list[tuple[int, int]]:
    """The radix-4 (then radix-2) passes of the kernel's in-register
    ``radix``-point DFT, as ``(p, ns)``."""
    plan, ns = [], 1
    while ns < radix:
        p = 4 if radix // ns >= 4 else 2
        plan.append((p, ns))
        ns *= p
    return plan


def _w16_index(j: int, r: int, p: int, ns: int) -> int:
    """Which 16th root of unity the in-register DFT multiplies by."""
    return (j % ns) * r * (16 // (ns * p)) % 16


def _butterfly_flops(radix: int) -> int:
    """Operations of the kernel's in-register ``radix``-point DFT: for a
    power of two, additions and a product for every root of unity that is
    not 1, -1, i or -i; for an odd radix ``2h + 1``, the sums and
    differences of the ``h`` mirrored pairs and output 0's sum (6 a pair),
    then for each of the ``h`` output pairs 4 multiply-adds a mirrored pair
    and 4 additions."""
    if radix & (radix - 1):
        h = radix // 2
        return 6 * h + h * (8 * h + 4)
    dft = 0
    for p, ns in _small_plan(radix):
        q = radix // p
        dft += q * (16 if p == 4 else 4)
        dft += 6 * sum(_w16_index(j, r, p, ns) % 4 != 0 for j in range(q) for r in range(p))
    return dft


def fft_flops(n_fft: int) -> int:
    """Floating-point operations of the FFT route's complex transform of one
    frame (:func:`fft_plan`): per pass, each butterfly's twiddle products
    (none in the first pass) and its in-register DFT. Under Bluestein, two
    transforms, the chirp on the ``n`` inputs (6 a point, 2 for a real
    one), the filter on the ``m`` points (6), and the chirp on the ``n``
    outputs when the untangle needs their phase (6; an odd ``n_fft`` takes
    only their power)."""
    plan = fft_plan(n_fft)
    total = sum((plan.m // r) * (_butterfly_flops(r) + (6 * (r - 1) if i else 0))
                for i, (r, _) in enumerate(plan.passes))
    if plan.bluestein:
        total = (2 * total + (6 if plan.packed else 2) * plan.n + 6 * plan.m
                 + (6 * plan.n if plan.packed else 0))
    return total


def _pairs(w: np.ndarray) -> np.ndarray:
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


@lru_cache(maxsize=None)
def twiddles(n_fft: int) -> np.ndarray:
    """``exp(-2 pi i k / n_fft)`` for ``k < n_fft`` as ``(n_fft, 2)`` f32
    (re, im), computed in float64 and rounded once."""
    return _pairs(np.exp(-2j * np.pi * np.arange(n_fft) / n_fft))


def _chirp64(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.int64)
    return np.exp(-1j * np.pi * ((k * k) % (2 * n)) / n)


@lru_cache(maxsize=None)
def chirp(n: int) -> np.ndarray:
    """Bluestein's chirp ``exp(-i pi k^2 / n)`` for ``k < n`` as ``(n, 2)``
    f32, with ``k^2 mod 2n`` taken in integers before the float64 phase."""
    return _pairs(_chirp64(n))


@lru_cache(maxsize=None)
def chirp_filter(n: int, m: int) -> np.ndarray:
    """Bluestein's filter as the kernel multiplies by it: ``conj(B) / m``
    with ``B`` the ``m``-point FFT of ``b``, the chirp's conjugate at ``k``
    and ``m - k`` for ``k < n``; ``(m, 2)`` f32 from float64. The conjugate
    and ``1/m`` turn the second forward transform into the inverse one:
    ``ifft(A B) = conj(fft(conj(A) conj(B) / m))``."""
    c = np.conj(_chirp64(n))
    b = np.zeros(m, np.complex128)
    b[:n] = c
    b[m - n + 1:] = c[1:][::-1]
    return _pairs(np.conj(np.fft.fft(b)) / m)


def _dft_matrix(r: int) -> torch.Tensor:
    s = np.arange(r)
    return torch.from_numpy(np.exp(-2j * np.pi * np.outer(s, s) / r).astype(np.complex64))


def _stockham(z: torch.Tensor, plan: FftPlan, tw: torch.Tensor) -> torch.Tensor:
    """The kernel's passes over ``(..., m)`` complex64 points, twiddles from
    the table ``tw`` (``exp(-2 pi i k / len(tw))``)."""
    for i, (r, ns) in enumerate(plan.passes):
        q = plan.m // r
        j = torch.arange(q)
        k = j % ns
        src = j[:, None] + q * torch.arange(r)[None, :]
        v = z[..., src]                                        # (..., q, r)
        if i:
            v = v * tw[k[:, None] * torch.arange(r)[None, :] * (len(tw) // (ns * r))]
        v = v @ _dft_matrix(r)
        out = torch.empty_like(z)
        out[..., ((j - k) * r + k)[:, None] + ns * torch.arange(r)[None, :]] = v
        z = out
    return z


def rdft_by_plan(frames: torch.Tensor, n_fft: int,
                 dc_in_sample_order: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the FFT route's transform, by
    :func:`fft_plan` and the kernel's f32 tables, in complex64 (the tests'
    check of the plan): ``(..., L)`` f32 frames, ``L <= n_fft`` -> their
    ``n_fft``-point real DFT ``(..., n_fft//2 + 1)``. The packing, the chirp
    and Bluestein's filter, the passes and the untangle; the DC bin as the
    kernel takes it, the frame's sum in sample order, unless
    ``dc_in_sample_order`` is false (then the transform's own)."""
    plan = fft_plan(n_fft)
    table = lambda a: torch.view_as_complex(torch.from_numpy(a).contiguous())
    e = torch.nn.functional.pad(frames.float(), (0, n_fft - frames.shape[-1]))
    z = torch.complex(e[..., 0::2], e[..., 1::2]) if plan.packed else e.to(torch.complex64)
    if plan.bluestein:
        c = table(chirp(plan.n))
        z = torch.nn.functional.pad(z * c, (0, plan.m - plan.n))
        z = _stockham(z, plan, table(twiddles(plan.m)))
        z = _stockham(z.conj() * table(chirp_filter(plan.n, plan.m)), plan,
                      table(twiddles(plan.m)))
        z = c * z[..., :plan.n].conj()
    else:
        z = _stockham(z, plan, table(twiddles(n_fft)))
    bins = torch.arange(n_fft // 2 + 1)
    if plan.packed:
        a, b = z[..., bins % plan.n], z[..., (plan.n - bins) % plan.n].conj()
        x = 0.5 * (a + b) - 0.5j * table(twiddles(n_fft))[bins] * (a - b)
    else:
        x = z[..., bins]
    if not dc_in_sample_order:
        return x
    dc = torch.zeros_like(e[..., 0])
    for i in range(frames.shape[-1]):
        dc = dc + frames[..., i].float()
    return torch.cat([torch.complex(dc, torch.zeros_like(dc))[..., None], x[..., 1:]], -1)


@lru_cache(maxsize=None)
def mel_csr(n_filt: int, n_fft: int, rate: int, low_freq: float = 0.0,
            high_freq: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The f32 mel filterbank by filter: ``idx`` ``(3, n_filt)`` int32 rows
    of each filter's first nonzero bin, bin count and offset into
    ``weights``, the filters' weights from the first to the last nonzero
    bin, in order. A filter with no nonzero weight has count 0."""
    fb = spectral.mel_filterbank(n_filt, n_fft, rate, low_freq, high_freq)
    idx = np.zeros((3, n_filt), np.int32)
    weights = []
    for m in range(n_filt):
        nz = np.flatnonzero(fb[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        idx[:, m] = lo, hi - lo, sum(len(w) for w in weights)
        weights.append(fb[lo:hi, m])
    return idx, np.concatenate(weights).astype(np.float32)


# ----------------------------------------------------------------- kernels
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {   # entry -> (launch-count keys, argtypes)
    "fbank_fft_features": (("fft",), [_P] * 8 + [_I] * 11 + [_F, _P]),
    "fbank_mixed_fft_features": (("mixed",), [_P] * 11 + [ctypes.POINTER(_I)] + [_I] * 13
                                 + [_F, _P]),
}
_entry = build.entries("fbank_fft_kernel", _SIGNATURES)


def _upload(device: torch.device, *arrays) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


@lru_cache(maxsize=None)
def _fft_constants(device: torch.device, n_fft: int, num_bin: int, rate: int,
                   low_freq: float, high_freq: float | None, num_cep: int,
                   ceplifter: int):
    """``(twiddles, mel idx, mel weights, dct, lift)`` on ``device``."""
    idx, weights = mel_csr(num_bin, n_fft, rate, low_freq, high_freq)
    return _upload(device, twiddles(n_fft), idx, weights,
                   spectral.dct_matrix(num_cep, num_bin).astype(np.float32),
                   spectral.cepstral_lifter(num_cep, ceplifter).astype(np.float32))


@lru_cache(maxsize=None)
def _mixed_constants(device: torch.device, n_fft: int, num_bin: int, rate: int,
                     low_freq: float, high_freq: float | None, num_cep: int,
                     ceplifter: int):
    """``(plan, radices, tables)`` for the mixed kernel: the plan's radices
    as a C array, and on ``device`` the passes' twiddles (``m`` points under
    Bluestein, else ``n_fft``), the untangle's ``n_fft``-point twiddles, the
    chirp and the filter (None without Bluestein), mel idx and weights, dct,
    lift."""
    plan = fft_plan(n_fft)
    radices = (ctypes.c_int * len(plan.passes))(*(r for r, _ in plan.passes))
    idx, weights = mel_csr(num_bin, n_fft, rate, low_freq, high_freq)
    tw_unt, = _upload(device, twiddles(n_fft))
    if plan.bluestein:
        tw, c, filt = _upload(device, twiddles(plan.m), chirp(plan.n),
                              chirp_filter(plan.n, plan.m))
    else:
        tw, c, filt = tw_unt, None, None
    rest = _upload(device, idx, weights,
                   spectral.dct_matrix(num_cep, num_bin).astype(np.float32),
                   spectral.cepstral_lifter(num_cep, ceplifter).astype(np.float32))
    return plan, radices, (tw, tw_unt, c, filt) + rest


def out_dim(cfg: F.FeatureConfig) -> int:
    return cfg.num_cep if cfg.feat_type == "mfcc" else cfg.num_bin


def _kernel_args(pcm: torch.Tensor, cfg: F.FeatureConfig, sample_lengths, what: str):
    """Check a batch for a kernel; ``(lengths or None, out)``."""
    if cfg.feat_type not in _FEAT_CODES:
        raise NotImplementedError(f"not a mel front-end: {cfg.feat_type!r}")
    if pcm.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda, not {pcm.device}")
    if pcm.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 PCM, got {pcm.dtype}")
    if pcm.ndim != 2 or not pcm.is_contiguous():
        raise ValueError(
            f"{what} takes a contiguous (B, S) batch, got shape "
            f"{tuple(pcm.shape)} contiguous={pcm.is_contiguous()}")
    if cfg.frame_len > cfg.n_fft:
        raise ValueError(f"frame_len {cfg.frame_len} > n_fft {cfg.n_fft}")
    b, s = pcm.shape
    lengths = None
    if sample_lengths is not None:
        lengths = torch.as_tensor(sample_lengths).to(
            device=pcm.device, dtype=torch.int32).contiguous()
        if tuple(lengths.shape) != (b,):
            raise ValueError(f"sample_lengths of shape {tuple(lengths.shape)} for {b} rows")
    t = framing.num_frames(s, cfg.frame_len, cfg.frame_step)
    out = torch.empty((b, t, out_dim(cfg)), dtype=torch.float32, device=pcm.device)
    return lengths, out


def fft_audio_features(pcm: torch.Tensor, cfg: F.FeatureConfig,
                       sample_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The FFT kernel's power-of-two plan on a CUDA batch; raises for an
    ``n_fft`` it does not take."""
    if front_end_kernel(cfg) != "fft":
        raise ValueError(f"the FFT kernel takes a power-of-two n_fft in "
                         f"[{FFT_SIZES[0]}, {FFT_SIZES[1]}], not {cfg.n_fft}")
    lengths, out = _kernel_args(pcm, cfg, sample_lengths, "fft_audio_features")
    (b, s), t = pcm.shape, out.shape[1]
    if b == 0:
        return out
    tw, idx, w, dct, lift = _fft_constants(
        pcm.device, cfg.n_fft, cfg.num_bin, cfg.rate, cfg.low_freq, cfg.high_freq,
        cfg.num_cep, cfg.ceplifter)
    with torch.cuda.device(pcm.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.launch(
            _entry("fbank_fft_features"),
            pcm.data_ptr(), None if lengths is None else lengths.data_ptr(),
            tw.data_ptr(), idx.data_ptr(), w.data_ptr(), dct.data_ptr(), lift.data_ptr(),
            out.data_ptr(), b, s, t, cfg.frame_len, cfg.frame_step, cfg.n_fft, cfg.num_bin,
            cfg.num_cep, w.numel(), _FEAT_CODES[cfg.feat_type], int(cfg.energy), cfg.preemph,
            stream)
    return out


def mixed_fft_audio_features(pcm: torch.Tensor, cfg: F.FeatureConfig,
                             sample_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The FFT kernel's mixed-radix and Bluestein plan (:func:`fft_plan`) on
    a CUDA batch, for an ``n_fft`` in ``FFT_SIZES`` that is no power of
    two; raises for any other."""
    if front_end_kernel(cfg) != "mixed":
        raise ValueError(f"the mixed-radix FFT takes an n_fft in [{FFT_SIZES[0]}, "
                         f"{FFT_SIZES[1]}] that is no power of two, not {cfg.n_fft}")
    lengths, out = _kernel_args(pcm, cfg, sample_lengths, "mixed_fft_audio_features")
    (b, s), t = pcm.shape, out.shape[1]
    if b == 0:
        return out
    plan, radices, tables = _mixed_constants(
        pcm.device, cfg.n_fft, cfg.num_bin, cfg.rate, cfg.low_freq, cfg.high_freq,
        cfg.num_cep, cfg.ceplifter)
    tw, tw_unt, c, filt, idx, w, dct, lift = tables
    ptr = lambda a: None if a is None else a.data_ptr()
    with torch.cuda.device(pcm.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.launch(
            _entry("fbank_mixed_fft_features"),
            pcm.data_ptr(), ptr(lengths), tw.data_ptr(), tw_unt.data_ptr(), ptr(c), ptr(filt),
            idx.data_ptr(), w.data_ptr(), dct.data_ptr(), lift.data_ptr(), out.data_ptr(),
            radices, b, s, t, cfg.frame_len, cfg.frame_step, cfg.n_fft, plan.m,
            len(plan.passes), cfg.num_bin, cfg.num_cep, w.numel(),
            _FEAT_CODES[cfg.feat_type], int(cfg.energy), cfg.preemph, stream)
    return out


def audio_features_reference(pcm: torch.Tensor, cfg: F.FeatureConfig,
                             sample_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels: pre-emphasis, then the mask at
    each row's length (the op order of ``extract_features`` in the JAX
    package), then the plain front-end of ``ops.features`` at ``cfg.dft``
    (``'matmul'`` unless the config asks for ``'fft'``)."""
    if cfg.feat_type not in _FEAT_CODES:
        raise NotImplementedError(f"not a mel front-end: {cfg.feat_type!r}")
    signal = framing.preemphasis(pcm, cfg.preemph) if cfg.preemph else pcm
    if sample_lengths is not None:
        idx = torch.arange(signal.shape[-1], device=signal.device)
        mask = idx < torch.as_tensor(sample_lengths).to(signal.device)[..., None]
        signal = signal * mask.to(signal.dtype)
    fn = {"mfcc": F.mfcc, "fbank": F.fbank, "logfbank": F.logfbank}[cfg.feat_type]
    return fn(signal, dataclasses.replace(cfg, preemph=0.0))


def audio_features(pcm: torch.Tensor, cfg: F.FeatureConfig,
                   sample_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Fused front-end ``(B, S) -> (B, T, D)`` on raw PCM: pre-emphasis at
    ``cfg.preemph``, then, with ``sample_lengths``, zero from each row's
    length on. A CPU batch goes to the plain version; a CUDA batch to the
    kernel :func:`front_end_kernel` names, and is refused where it names
    none."""
    if cfg.feat_type not in _FEAT_CODES:
        raise NotImplementedError(f"not a mel front-end: {cfg.feat_type!r}")
    if pcm.device.type == "cpu":
        return audio_features_reference(pcm, cfg, sample_lengths)
    if pcm.device.type != "cuda":
        raise ValueError(f"audio_features runs on cuda or cpu, not {pcm.device}")
    kind = front_end_kernel(cfg)
    if kind == "plain":
        raise ValueError(f"no front-end kernel takes n_fft {cfg.n_fft} on a CUDA batch: "
                         f"the FFT route takes [{FFT_SIZES[0]}, {FFT_SIZES[1]}]")
    kernel = {"fft": fft_audio_features, "mixed": mixed_fft_audio_features}[kind]
    return kernel(pcm, cfg, sample_lengths)
