"""Diffusion samplers of the port: schedules, the DDPM/DDIM step, and the
nested (multi-resolution) sampler.

Counterpart of ``ml_mdm_tpu/samplers.py`` ``Sampler`` and
``NestedSampler``. The gamma tables are the JAX package's numpy builders,
copied here because importing them would import JAX. The denoise loop is
one Python loop over the timestep table (``_steps``), behind ``sample``
(with ``return_sequence``), the web demo's ``sample_stream`` and
``sample_chunked``. Per-image gammas broadcast as
(B, 1, 1, 1) against NHWC images; coefficients are computed in f32 and
applied in the carry's dtype.

The training side (``get_eps_time``, ``get_xt``, ``get_prediction_targets``
and their nested forms) keeps the same rule: coefficients in f32, applied
in the images' dtype. Timesteps and noise come from the caller or from an
explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ml_mdm_tpu_torch.config import (
    PredictionType,
    SamplerConfig,
    ScheduleType,
    ThresholdType,
)
from ml_mdm_tpu_torch.utils.resize import resize_nhwc


def schedule_cosine(timesteps: int, logsnr_min: float = -5.0,
                    logsnr_max: float = 5.0) -> np.ndarray:
    t = np.linspace(0.0, 1.0, num=timesteps)
    b = np.arctan(np.exp(-0.5 * logsnr_max))
    a = np.arctan(np.exp(-0.5 * logsnr_min)) - b
    logsnrs = -2.0 * np.log(np.tan(a * t + b))
    gammas = 1.0 / (1.0 + np.exp(-logsnrs))
    return np.concatenate(([1.0], gammas))


def schedule_ddpm_linear(timesteps: int, beta_start: float,
                         beta_end: float) -> np.ndarray:
    betas = np.concatenate(([0.0], np.linspace(beta_start, beta_end, num=timesteps)))
    return np.exp(np.cumsum(np.log(1.0 - betas)))


def schedule_squaredcos_cap_v2(timesteps: int) -> np.ndarray:
    def alpha_bar(ts: float) -> float:
        return math.cos((ts + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = [0.0]
    for i in range(timesteps):
        t1, t2 = i / timesteps, (i + 1) / timesteps
        betas.append(min(1.0 - alpha_bar(t2) / alpha_bar(t1), 0.999))
    return np.exp(np.cumsum(np.log(1.0 - np.asarray(betas))))


def schedule_sigmoid(timesteps: int, beta_start: float,
                     beta_end: float) -> np.ndarray:
    ramp = 1.0 / (1.0 + np.exp(-np.linspace(-6.0, 6.0, num=timesteps)))
    betas = np.concatenate(([0.0], beta_start + (beta_end - beta_start) * ramp))
    return np.exp(np.cumsum(np.log(1.0 - betas)))


def build_gammas(config: SamplerConfig) -> np.ndarray:
    st = config.schedule_type
    n = config.num_diffusion_steps
    if st == ScheduleType.COSINE:
        return schedule_cosine(n)
    if st == ScheduleType.DDPM:
        return schedule_ddpm_linear(n, config.beta_start, config.beta_end)
    if st == ScheduleType.DEEPFLOYD:
        return schedule_squaredcos_cap_v2(n)
    if st == ScheduleType.SIGMOID:
        return schedule_sigmoid(n, config.beta_start, config.beta_end)
    raise ValueError(f"Unknown schedule type {st}")


def shift_gammas(gammas: np.ndarray, scale_factor: Optional[float],
                 power: float = 1.0) -> np.ndarray:
    """Resolution-shifted schedule: the SNR divided by scale_factor**power
    (in f32, as the JAX package computes it)."""
    if scale_factor is not None and scale_factor > 1:
        sf = np.float32(float(scale_factor) ** power)
        with np.errstate(divide="ignore"):  # gamma[0] == 1: snr inf, as in JAX
            snr = gammas / (np.float32(1.0) - gammas)
        return (np.float32(1.0) / (np.float32(1.0) + sf / np.maximum(snr, np.float32(1e-20)))).astype(np.float32)
    return gammas


def shift_gammas_tensor(gammas: torch.Tensor, scale_factor: Optional[float],
                        power: float = 1.0) -> torch.Tensor:
    """``shift_gammas`` on a tensor of per-image gammas, in f32 with the
    JAX package's operations (an explicit division by the SNR: torch's
    ``scalar / tensor`` multiplies by the reciprocal, one rounding more)."""
    if scale_factor is not None and scale_factor > 1:
        snr = gammas / (1.0 - gammas)
        sf = torch.full_like(snr, float(scale_factor) ** power)
        return torch.reciprocal(1.0 + torch.div(sf, torch.clamp(snr, min=1e-20)))
    return gammas


def vdm_loss_weights(gammas: np.ndarray) -> np.ndarray:
    """Variational Diffusion Model per-step loss weights."""
    g = gammas[2:]
    g_last = gammas[1:-1]
    w = g_last * (1.0 - g) / (1.0 - g_last) / g - 1.0
    return np.concatenate([w[:1], w[:1], w])


ModelFn = Callable[..., torch.Tensor]
# noise(step, level, x) -> a standard-normal tensor like x, for the step's
# stochastic update at one resolution
NoiseFn = Callable[[int, int, torch.Tensor], torch.Tensor]


class Sampler:
    """model_fn(x_t, times, lm_outputs, lm_mask, micros) -> prediction."""

    def __init__(self, config: SamplerConfig):
        self.config = config
        self.n_steps = config.num_diffusion_steps
        base = build_gammas(config).astype(np.float32)
        gammas = shift_gammas(base, config.rescale_schedule,
                              config.schedule_shifted_power)
        self.gammas = torch.from_numpy(np.asarray(gammas, dtype=np.float32))
        self.vdm_loss_weights = torch.from_numpy(
            vdm_loss_weights(np.asarray(gammas, dtype=np.float32)))
        self._tables_on = {}  # (table, device) -> copy of the table there

    def _table_on(self, name: str, device: torch.device) -> torch.Tensor:
        """A table copied to ``device`` once (a copy from host memory
        synchronises the stream)."""
        table = self._tables_on.get((name, device))
        if table is None:
            table = self._tables_on[(name, device)] = getattr(self, name).to(device)
        return table

    def read_gamma(self, time: torch.Tensor) -> torch.Tensor:
        """Gamma at integer timesteps (B,) -> (B, 1, 1, 1) f32."""
        return self._table_on("gammas", time.device)[time].reshape(-1, 1, 1, 1)

    # -- training side ---------------------------------------------------------

    def get_eps_time(self, images: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     time: Optional[torch.Tensor] = None,
                     eps: Optional[torch.Tensor] = None):
        """(eps, gamma_t, gamma_{t-1}, vdm weights, t) for a batch: t (B,)
        uniform in [0, n_steps) and eps standard normal in the images'
        dtype, each given or drawn from ``generator``."""
        dev = images.device
        if time is None:
            time = torch.randint(0, self.n_steps, (images.shape[0],),
                                 generator=generator, device=dev)
        if eps is None:
            eps = torch.randn(images.shape, generator=generator, device=dev,
                              dtype=images.dtype)
        time, eps = time.to(dev), eps.to(dev, images.dtype)
        weights = self._table_on("vdm_loss_weights", dev)[time + 1]
        return eps, self.read_gamma(time + 1), self.read_gamma(time), weights, time

    def get_xt(self, images, eps, g):
        dt = images.dtype
        return torch.sqrt(g).to(dt) * images + torch.sqrt(1.0 - g).to(dt) * eps

    def get_image_rescaled(self, images, scale_factor=None):
        if scale_factor is None:
            scale_factor = self.config.rescale_signal
        if scale_factor:
            return images / scale_factor
        return images

    def get_prediction_targets(self, images, eps, g, g_last, prediction_type=None):
        pt = prediction_type or self.config.loss_target_type
        if pt in (PredictionType.DDPM, PredictionType.DDIM):
            return eps
        if pt == PredictionType.V_PREDICTION:
            dt = images.dtype
            return torch.sqrt(g).to(dt) * eps - torch.sqrt(1.0 - g).to(dt) * images
        raise ValueError(f"Unsupported prediction type {pt}")

    # -- sampling side ---------------------------------------------------------

    def get_x0_eps_from_pred(self, x_t, pred, g, prediction_type=None,
                             clip_fn=None, return_eps=True):
        pt = prediction_type or self.config.prediction_type
        cd = x_t.dtype
        sqg = torch.sqrt(g).to(cd)
        sq1mg = torch.sqrt(1.0 - g).to(cd)
        if pt in (PredictionType.DDPM, PredictionType.DDIM):
            x0 = (x_t - pred.to(cd) * sq1mg) / sqg
        elif pt == PredictionType.V_PREDICTION:
            x0 = x_t * sqg - pred.to(cd) * sq1mg
        else:
            raise ValueError(f"Unsupported prediction type {pt}")
        if clip_fn is not None:
            x0 = clip_fn(x0)
        if not return_eps:
            return x0
        return x0, (x_t - x0 * sqg) / sq1mg

    def get_pred_from_x0_xt(self, x_t, x0, g, prediction_type=None):
        """The model prediction that gives x0 at x_t (gamma g, f32)."""
        pt = prediction_type or self.config.prediction_type
        if pt in (PredictionType.DDPM, PredictionType.DDIM):
            return (x_t - x0 * torch.sqrt(g)) / torch.sqrt(1.0 - g)
        if pt == PredictionType.V_PREDICTION:
            return (torch.sqrt(g) * x_t - x0) / torch.sqrt(1.0 - g)
        raise ValueError(f"Unsupported prediction type {pt}")

    @staticmethod
    def _threshold_sample(sample, ratio=0.995, max_value=100.0):
        """Dynamic thresholding: clamp to the per-image |x| quantile."""
        b = sample.shape[0]
        flat = sample.reshape(b, -1).float()
        s = torch.quantile(flat.abs(), ratio, dim=1)
        s = torch.clamp(s, 1.0, max_value)[:, None]
        flat = torch.maximum(torch.minimum(flat, s), -s) / s
        return flat.reshape(sample.shape).to(sample.dtype)

    def clip_sample(self, pred_x0, image_scale=1.0):
        s = image_scale if image_scale else 1.0
        tf = self.config.threshold_function
        if tf == ThresholdType.CLIP:
            return torch.clamp(pred_x0 * s, -1.0, 1.0) / s
        if tf == ThresholdType.DYNAMIC:
            return self._threshold_sample(pred_x0 * s, 0.995, 100.0) / s
        if tf == ThresholdType.DYNAMIC_IF:
            return self._threshold_sample(pred_x0 * s, 0.95, 1.5) / s
        return pred_x0

    def get_prediction_xt_last(self, x_t, pred, g, g_last, prediction_type=None,
                               clip_fn=None, need_noise=None, ddim_eta=None,
                               input_noise=None, image_scale=None):
        """Unified DDPM/DDIM step from level g to g_last (each (B,1,1,1) f32).
        ddim_eta None: DDPM posterior mean; 0: deterministic DDIM; >0:
        stochastic DDIM. Returns (x0, x_t_last, eps)."""
        pt = prediction_type or self.config.prediction_type
        cd = x_t.dtype
        alpha = g / g_last
        beta = 1.0 - alpha
        beta_tilde = beta * (1.0 - g_last) / (1.0 - g)

        x0 = self.get_x0_eps_from_pred(x_t, pred, g, pt, return_eps=False)
        scale = 1.0 if image_scale is None else image_scale
        if clip_fn is None:
            x0 = torch.clamp(x0, -scale, scale) / scale
        else:
            x0 = clip_fn(x0, scale)
        x0 = x0.to(cd)

        def c(v):
            return v.to(cd)

        if ddim_eta is None:
            x_t_last = (x0 * c(beta * torch.sqrt(g_last) / (1.0 - g))
                        + x_t * c(torch.sqrt(alpha) * (1.0 - g_last) / (1.0 - g)))
        else:
            eps = (x_t - x0 * c(torch.sqrt(g))) / c(torch.sqrt(1.0 - g))
            if ddim_eta > 0:
                beta_tilde = (ddim_eta ** 2) * beta_tilde
                x_t_last = x0 * c(torch.sqrt(g_last)) + eps * c(
                    torch.sqrt(torch.clamp(1.0 - g_last - beta_tilde, min=0.0)))
            else:
                need_noise = False
                x_t_last = x0 * c(torch.sqrt(g_last)) + eps * c(torch.sqrt(1.0 - g_last))

        if need_noise is not False and need_noise is not None and input_noise is not None:
            mask = torch.as_tensor(need_noise, dtype=x_t_last.dtype,
                                   device=x_t_last.device)
            while mask.dim() < x_t_last.dim():
                mask = mask[..., None]
            x_t_last = x_t_last + mask * c(torch.sqrt(beta_tilde)) * input_noise

        eps_out = (x_t_last - c(torch.sqrt(g_last)) * x0) / c(torch.sqrt(1.0 - g_last))
        return x0, x_t_last, eps_out

    def forward_model(self, model_fn: ModelFn, x_t, t, lm_outputs, lm_mask,
                      micros, guidance_scale=1.0):
        """Model forward with classifier-free guidance: with guidance != 1
        the text rows are [uncond; cond] (2B) and the image batch is tiled
        2x for one forward."""
        if guidance_scale != 1.0:
            b = x_t.shape[0]
            if lm_outputs.shape[0] != 2 * b:
                raise ValueError("guidance needs 2B rows of lm_outputs")
            micros2 = {k: torch.cat([v, v]) for k, v in micros.items()}
            pred = model_fn(torch.cat([x_t, x_t]), torch.cat([t, t]),
                            lm_outputs, lm_mask, micros2)
            pred_uncond, pred_cond = pred.chunk(2)
            return pred_uncond + guidance_scale * (pred_cond - pred_uncond)
        return model_fn(x_t, t, lm_outputs, lm_mask, micros)

    def set_timesteps(self, num_inference_steps: int = 250) -> np.ndarray:
        step_ratio = (self.config.num_diffusion_steps + 1) / (num_inference_steps + 1)
        return ((np.arange(0, num_inference_steps + 1) * step_ratio)
                .round()[::-1].copy().astype(np.int64))

    def _timestep_table(self, num_inference_steps: int, resample_steps: bool,
                        t_start: int = -1) -> np.ndarray:
        if not resample_steps:
            num_inference_steps = self.n_steps
        ts = self.set_timesteps(num_inference_steps)
        if t_start > -1:
            ts = ts[ts <= t_start]
        return ts

    def step(self, model_fn: ModelFn, x_t, t: int, t_last: int, lm_outputs,
             lm_mask, micros, noise: Optional[torch.Tensor] = None,
             guidance_scale=1.0, ddim_eta=None):
        """One denoise step t -> t_last; the model sees time t - 1.
        ``noise`` is the standard normal of the stochastic update, or None
        where the step adds none (``_step_noise``)."""
        b = x_t.shape[0]
        tt = torch.full((b,), t, dtype=torch.long, device=x_t.device)
        ss = torch.full((b,), t_last, dtype=torch.long, device=x_t.device)
        g, g_last = self.read_gamma(tt), self.read_gamma(ss)
        pred = self.forward_model(model_fn, x_t, tt - 1, lm_outputs, lm_mask,
                                  micros, guidance_scale)
        x0, x_s, _ = self.get_prediction_xt_last(
            x_t, pred, g, g_last,
            prediction_type=self.config.prediction_type,
            clip_fn=self.clip_sample, need_noise=noise is not None,
            ddim_eta=ddim_eta, input_noise=noise,
            image_scale=self.config.rescale_signal,
        )
        return x0, x_s

    def _step_noise(self, i: int, t: int, t_last: int, x, ddim_eta,
                    generator: Optional[torch.Generator], step_noise: Optional[NoiseFn]):
        """The noise of step ``i`` (t -> t_last), drawn only where the step
        uses it (eta not 0 and t_last not 0): ``step_noise(i, 0, x)`` when
        given, else a draw from ``generator``."""
        if (ddim_eta is not None and ddim_eta == 0) or t_last == 0:
            return None
        if step_noise is not None:
            return step_noise(i, 0, x)
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    def _steps(self, model_fn: ModelFn, x_t, lm_outputs, lm_mask, micros, generator,
               num_inference_steps, ddim_eta, guidance_scale, resample_steps, t_start,
               step_noise, **step_kw):
        """The denoise loop as a generator of (t, t_last, x0, x_t) per step:
        the one loop behind ``sample`` and ``sample_stream``."""
        ts = self._timestep_table(num_inference_steps, resample_steps, t_start)
        for i, (t, t_last) in enumerate(zip(ts[:-1].tolist(), ts[1:].tolist())):
            noise = self._step_noise(i, t, t_last, x_t, ddim_eta, generator, step_noise)
            x0, x_t = self.step(model_fn, x_t, t, t_last, lm_outputs, lm_mask, micros,
                                noise, guidance_scale, ddim_eta, **step_kw)
            yield t, t_last, x0, x_t

    def sample(self, model_fn: ModelFn, x_t, lm_outputs, lm_mask,
               micros: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               num_inference_steps: int = 2000, ddim_eta=None,
               guidance_scale: float = 1.0, resample_steps: bool = False,
               t_start: int = -1, return_sequence: bool = False,
               step_noise: Optional[NoiseFn] = None):
        """Full denoise loop; returns the final image rescaled and clipped
        to [-1, 1], and with ``return_sequence`` also every step's x_t
        stacked (S, B, H, W, C), rescaled and not clipped. The stochastic
        update's noise comes from ``step_noise(step, 0, x)`` when given (a
        test feeds the JAX package's draws through it), else from
        ``generator``."""
        seq = []
        for _, _, _, x_t in self._steps(model_fn, x_t, lm_outputs, lm_mask, micros, generator,
                                        num_inference_steps, ddim_eta, guidance_scale,
                                        resample_steps, t_start, step_noise):
            if return_sequence:
                seq.append(x_t)
        out = self._postprocess(x_t, clip=True)
        if return_sequence:
            return out, self._postprocess(torch.stack(seq))
        return out

    def sample_chunked(self, *args, chunk_steps: int = 50, **kwargs):
        """``sample`` itself. ``chunk_steps`` is unused: the JAX package runs
        its scan in chunks of that many steps to stay under a TPU runtime's
        call deadline, and the port's loop is a host loop."""
        return self.sample(*args, **kwargs)

    def sample_stream(self, model_fn: ModelFn, x_t, lm_outputs, lm_mask, micros,
                      generator: Optional[torch.Generator] = None,
                      num_inference_steps: int = 2000, ddim_eta=None,
                      guidance_scale: float = 1.0, resample_steps: bool = False,
                      t_start: int = -1, step_noise: Optional[NoiseFn] = None):
        """The denoise loop as a generator of (x0, x_t, (g, g_last)) per
        step, both images rescaled and only the last x_t clipped (the web
        demo's previews); g and g_last are the step's gammas (f32 scalars)."""
        steps = self._steps(model_fn, x_t, lm_outputs, lm_mask, micros, generator,
                            num_inference_steps, ddim_eta, guidance_scale, resample_steps,
                            t_start, step_noise)
        n = len(self._timestep_table(num_inference_steps, resample_steps, t_start)) - 1
        for i, (t, t_last, x0, x_t) in enumerate(steps):
            yield (self._postprocess(x0), self._postprocess(x_t, clip=i == n - 1),
                   (self.gammas[t], self.gammas[t_last]))

    def _postprocess(self, x_t, clip=False, image_scale=None):
        if image_scale is None:
            image_scale = self.config.rescale_signal
        if image_scale:
            x_t = x_t * image_scale
        if clip:
            x_t = torch.clamp(x_t, -1.0, 1.0)
        return x_t


class NestedSampler(Sampler):
    """Multi-resolution sampler: every resolution steps in lockstep.
    Images are lists [x_hi, ..., x_lo] of NHWC tensors; the model maps such
    a list to a list of predictions."""

    def get_schedule_shifted(self, gammas, scale_factor=None):
        return shift_gammas_tensor(gammas, scale_factor,
                                   self.config.schedule_shifted_power)

    def get_gammas(self, gamma, scales) -> List[torch.Tensor]:
        """Per-resolution gammas from a base (B, 1, 1, 1) gamma: the SNR
        divided by scale**power with ``schedule_shifted``."""
        if not self.config.schedule_shifted:
            return [gamma for _ in scales]
        return [self.get_schedule_shifted(gamma, s) for s in scales]

    def _at_scale(self, x, s):
        return x if self.config.schedule_shifted else self.get_image_rescaled(x, s)

    def get_xt(self, x0_list, eps_list, g_list, scales):
        return [super(NestedSampler, self).get_xt(self._at_scale(x, s), e, g)
                for x, s, e, g in zip(x0_list, scales, eps_list, g_list)]

    def get_prediction_targets(self, x0_list, eps_list, g_list, g_last_list, scales,
                               prediction_type=None):
        return [super(NestedSampler, self).get_prediction_targets(
                    self._at_scale(x, s), e, g, gl, prediction_type)
                for x, s, e, g, gl in zip(x0_list, scales, eps_list, g_list, g_last_list)]

    def forward_model(self, model_fn: ModelFn, x_t, t, lm_outputs, lm_mask,
                      micros, guidance_scale=1.0):
        """Model forward with classifier-free guidance on every resolution:
        with guidance != 1 the text rows are [uncond; cond] (2B) and each
        image is tiled 2x for one forward."""
        if guidance_scale != 1.0:
            b = x_t[0].shape[0]
            if lm_outputs.shape[0] != 2 * b:
                raise ValueError("guidance needs 2B rows of lm_outputs")
            micros2 = {k: torch.cat([v, v]) for k, v in micros.items()}
            preds = model_fn([torch.cat([x, x]) for x in x_t], torch.cat([t, t]),
                             lm_outputs, lm_mask, micros2)
            out = []
            for p in preds:
                pu, pc = p.chunk(2)
                out.append(pu + guidance_scale * (pc - pu))
            return out
        return model_fn(x_t, t, lm_outputs, lm_mask, micros)

    def step(self, model_fn: ModelFn, x_t: List[torch.Tensor], t: int, t_last: int,
             lm_outputs, lm_mask, micros,
             noise: Optional[Sequence[torch.Tensor]] = None,
             guidance_scale=1.0, ddim_eta=None, scales: Sequence[float] = (1.0,)):
        """One lockstep denoise step t -> t_last at every resolution; the
        model sees time t - 1. ``noise`` holds one standard-normal tensor
        per resolution for the stochastic update, or None when the step
        adds none (``_step_noise``)."""
        b = x_t[0].shape[0]
        dev = x_t[0].device
        tt = torch.full((b,), t, dtype=torch.long, device=dev)
        ss = torch.full((b,), t_last, dtype=torch.long, device=dev)
        g_t = self.get_gammas(self.read_gamma(tt), scales)
        g_s = self.get_gammas(self.read_gamma(ss), scales)
        p_t = self.forward_model(model_fn, x_t, tt - 1, lm_outputs, lm_mask,
                                 micros, guidance_scale)
        x0s, xss = [], []
        for j, (x, p, g, g_last, s) in enumerate(zip(x_t, p_t, g_t, g_s, scales)):
            x0, x_s, _ = self.get_prediction_xt_last(
                x, p, g, g_last,
                prediction_type=self.config.prediction_type,
                clip_fn=self.clip_sample, need_noise=noise is not None,
                ddim_eta=ddim_eta,
                input_noise=noise[j] if noise is not None else None,
                image_scale=1.0 if self.config.schedule_shifted else s,
            )
            x0s.append(x0)
            xss.append(x_s)
        return x0s, xss

    def init_noise(self, batch: int, channels: int, image_side: int, scales,
                   generator: Optional[torch.Generator] = None,
                   dtype=torch.float32, device=None) -> List[torch.Tensor]:
        """Fresh standard-normal x_T at every resolution."""
        sides = [int(image_side * s / scales[0]) for s in scales]
        return [torch.randn((batch, side, side, channels), generator=generator,
                            dtype=dtype, device=device) for side in sides]

    def _step_noise(self, i: int, t: int, t_last: int, x, ddim_eta,
                    generator: Optional[torch.Generator], step_noise: Optional[NoiseFn]):
        """One normal per resolution for step ``i``, drawn where the JAX
        step adds noise (eta not 0 and t not 1): ``step_noise(i, level, x)``
        when given, else draws from ``generator``."""
        if (ddim_eta is not None and ddim_eta == 0) or t == 1:
            return None
        if step_noise is not None:
            return [step_noise(i, j, xj) for j, xj in enumerate(x)]
        return [torch.randn(xj.shape, generator=generator, device=xj.device, dtype=xj.dtype)
                for xj in x]

    def sample(self, model_fn: ModelFn, x_t: List[torch.Tensor], lm_outputs,
               lm_mask, micros: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None, *,
               scales: Sequence[float], num_inference_steps: int = 2000,
               ddim_eta=None, guidance_scale: float = 1.0,
               resample_steps: bool = False, t_start: int = -1,
               return_sequence: bool = False, output_inner: bool = False,
               step_noise: Optional[NoiseFn] = None):
        """Full lockstep denoise loop. The stochastic update's noise comes
        from ``step_noise(step, level, x)`` when given (a test feeds the
        JAX package's draws through it), else from ``generator``. Returns
        the highest resolution rescaled and clipped to [-1, 1], or with
        ``output_inner`` every resolution side by side; with
        ``return_sequence`` also the highest resolution's x_t of every step
        stacked (S, B, H, W, C), as the sampler carries it (the JAX nested
        sampler neither rescales nor clips it)."""
        seq, xs = [], list(x_t)
        for _, _, _, xs in self._steps(model_fn, xs, lm_outputs, lm_mask, micros, generator,
                                       num_inference_steps, ddim_eta, guidance_scale,
                                       resample_steps, t_start, step_noise, scales=scales):
            if return_sequence:
                seq.append(xs[0])
        out = self._postprocess_nested(xs, clip=True, output_inner=output_inner)
        if return_sequence:
            return out, torch.stack(seq)
        return out

    def sample_stream(self, model_fn: ModelFn, x_t: List[torch.Tensor], lm_outputs,
                      lm_mask, micros, generator: Optional[torch.Generator] = None, *,
                      scales: Sequence[float], num_inference_steps: int = 2000,
                      ddim_eta=None, guidance_scale: float = 1.0,
                      resample_steps: bool = False, t_start: int = -1,
                      output_inner: bool = False, step_noise: Optional[NoiseFn] = None):
        """The lockstep loop as a generator of (x0, x_t, (g, g_last)) per
        step, each image as ``_postprocess_nested`` gives it (only the last
        x_t clipped)."""
        steps = self._steps(model_fn, list(x_t), lm_outputs, lm_mask, micros, generator,
                            num_inference_steps, ddim_eta, guidance_scale, resample_steps,
                            t_start, step_noise, scales=scales)
        n = len(self._timestep_table(num_inference_steps, resample_steps, t_start)) - 1
        for i, (t, t_last, x0s, xs) in enumerate(steps):
            yield (self._postprocess_nested(x0s, output_inner=output_inner),
                   self._postprocess_nested(xs, clip=i == n - 1, output_inner=output_inner),
                   (self.gammas[t], self.gammas[t_last]))

    def _postprocess_nested(self, x_t: List[torch.Tensor], clip=False,
                            output_inner=False):
        scales = [1.0 if self.config.schedule_shifted else x.shape[-2] / x_t[-1].shape[-2]
                  for x in x_t]
        out = self._postprocess(x_t[0], clip=clip, image_scale=scales[0])
        if not output_inner:
            return out
        size = out.shape[-3]
        panes = [out]
        for x, s in zip(x_t[1:], scales[1:]):
            oi = self._postprocess(x, clip=clip, image_scale=s)
            panes.append(resize_nhwc(oi, size, size, "bilinear"))
        return torch.cat(panes[::-1], dim=-2)  # side by side along the width
