"""Feature assembly on the device (deepfake_tpu/data/pipeline.py:36-257):
raw batches (uint8 frames, bucket-padded 16 kHz PCM with valid lengths)
become model inputs. Frames and mel JPEG images are ImageNet-normalised;
PCM becomes the mel image (``mel_image_masked``) for the ``audio`` input
and a normalised waveform for the ``paudio`` input. Everything runs in f32
on the assembler's device; the caller casts the result to its compute type.

For training, frames are augmented on the device and ``batch_longest``
waves are normalised per accumulation micro-batch (``FeatureAssembler``
with ``train=True``). ``video_swin`` clips stay NTHWC (the JAX package's
channel-folded and pre-windowed host feeds are TPU layout work).

``DevicePrefetcher`` moves a loader's raw batches to the device ahead of
their use (deepfake_tpu/data/pipeline.py:260-309, the reference's
CudaDataLoader): a producer thread decodes and collates, and writes each
batch into pinned host buffers; the main thread copies it to the device on
a side stream. ``ModelFeedLoader`` assembles those batches into model
inputs for the Trainer.
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from deepfake_tpu_torch.config import Config
from deepfake_tpu_torch.ops.image import (
    imagenet_stats, normalize_imagenet, preprocess_clip_batch,
)
from deepfake_tpu_torch.ops.mel import full_f32_matmul, mel_filterbank, stft_power
from deepfake_tpu_torch.ops.resample import resample, resampled_length
from deepfake_tpu_torch.parallel.mesh import (
    batch_state, data_rows, global_max, splits_train_batch,
)


def hf_wave_normalize(wave: torch.Tensor) -> torch.Tensor:
    """Wav2Vec2Processor statistics over the FULL padded row (zeros included)."""
    mean = wave.mean(dim=1, keepdim=True)
    var = wave.var(dim=1, keepdim=True, correction=0)
    return (wave - mean) / torch.sqrt(var + 1e-7)


def batch_longest_wave_normalize(wave: torch.Tensor, length: torch.Tensor,
                                 longest: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference processor's statistics: each row as if padded to the
    batch's longest valid length L (the zeros between a row's length and L
    count, the bucket's padding past L does not); every position normalised.
    ``longest``: L where the batch is wider than these rows (a mesh)."""
    L = (length.max() if longest is None else longest).to(wave.dtype)
    mask = (torch.arange(wave.shape[1], device=wave.device)[None] < length[:, None]).to(wave.dtype)
    n = length[:, None].to(wave.dtype)
    mean = (wave * mask).sum(dim=1, keepdim=True) / L
    sq = (mask * (wave - mean) ** 2).sum(dim=1, keepdim=True) + (L - n) * mean ** 2
    return (wave - mean) / torch.sqrt(sq / L + 1e-7)


def masked_wave_normalize(wave: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Statistics over the valid prefix only, zeros beyond it."""
    mask = (torch.arange(wave.shape[1], device=wave.device)[None] < length[:, None]).to(wave.dtype)
    n = torch.clamp(length.to(wave.dtype), min=1.0)[:, None]
    mean = (wave * mask).sum(dim=1, keepdim=True) / n
    var = (mask * (wave - mean) ** 2).sum(dim=1, keepdim=True) / n
    return mask * (wave - mean) / torch.sqrt(var + 1e-7)


@functools.lru_cache(maxsize=4)
def _mel_matrix(sr: int, n_fft: int, n_mels: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(device)


@functools.lru_cache(maxsize=8)
def _resize_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """[n_out, n_in] f32 weights of jax.image.resize(..., "linear") along one
    axis: a triangle kernel at half-pixel centres, widened by n_in / n_out
    when downsampling (antialiasing), each column normalised."""
    inv = np.float32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / max(inv, 1.0)
    w = np.maximum(np.float32(0.0), 1 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0)
    return torch.from_numpy(np.ascontiguousarray(w.T, dtype=np.float32)).to(device)


def _resize_axis_dynamic(img: torch.Tensor, valid: torch.Tensor, out_len: int) -> torch.Tensor:
    """Linear resize of each row's valid prefix [0, valid) of the last axis
    to ``out_len`` (half-pixel centres): img [B, R, n], valid [B]."""
    B, R, n = img.shape
    v = valid.to(torch.float32)[:, None]
    src = (torch.arange(out_len, dtype=torch.float32, device=img.device)[None] + 0.5) * (
        v / out_len) - 0.5
    src = torch.minimum(torch.clamp(src, min=0.0), v - 1.0)
    lo = torch.clamp(torch.floor(src).long(), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    w = (src - lo.to(torch.float32))[:, None, :]
    take = lambda i: torch.gather(img, 2, i[:, None, :].expand(B, R, out_len))
    return take(lo) * (1 - w) + take(hi) * w


def mel_image_masked(wave: torch.Tensor, length: torch.Tensor, sr: int = 22050,
                     n_fft: int = 2048, hop: int = 512, n_mels: int = 128, size: int = 224,
                     wave_sr: Optional[int] = None, raw_uint8: bool = False) -> torch.Tensor:
    """[B, T] padded PCM and valid lengths [B] -> [B, size, size, 3] mel
    images over each clip's valid region (or, with ``raw_uint8``, the
    [B, size, size] uint8 image before normalisation).

    PCM at ``wave_sr`` is resampled to ``sr`` first. Per clip: reflect
    padding of n_fft / 2 around the valid region (the right reflection
    bounces at ln - 1), the windowed power spectrum, the mel filterbank,
    dB against the max over the valid frames with the 80 dB floor, min-max
    over the valid frames to [0, 255] and rounded, the mel axis resized to
    ``size``, the valid frames resized to ``size``, rounded; then /255,
    three channels and ImageNet normalisation."""
    wave = wave.float()
    length = length.long()
    if wave_sr is not None and wave_sr != sr:
        length = resampled_length(length, wave_sr, sr)
        wave = resample(wave, wave_sr, sr)
    B, T = wave.shape
    dev = wave.device
    pad = n_fft // 2
    ln = length[:, None]
    idx = (torch.arange(T + 2 * pad, device=dev) - pad).abs()[None]
    idx = torch.where(idx >= ln, torch.clamp(2 * ln - 2 - idx, min=0), idx).clamp(0, T - 1)
    frames = torch.gather(wave, 1, idx).unfold(1, n_fft, hop)  # [B, frames, n_fft]
    spec = stft_power(frames, n_fft)
    with full_f32_matmul():
        S = _mel_matrix(sr, n_fft, n_mels, dev) @ spec.transpose(1, 2)
    n_frames = 1 + length // hop  # librosa's center=True frame count
    fmask = (torch.arange(S.shape[2], device=dev)[None] < n_frames[:, None])[:, None, :]
    amin = 1e-10
    ref = torch.clamp((S * fmask).amax(dim=(1, 2), keepdim=True), min=amin)
    db = 10.0 * torch.log10(torch.clamp(S, min=amin)) - 10.0 * torch.log10(ref)
    top = torch.where(fmask, db, -torch.inf).amax(dim=(1, 2), keepdim=True)
    db = torch.maximum(db, top - 80.0)
    lo = torch.where(fmask, db, torch.inf).amin(dim=(1, 2), keepdim=True)
    img = torch.clamp(torch.round((db - lo) * (255.0 / torch.clamp(top - lo, min=1e-12))), 0, 255)
    with full_f32_matmul():
        img = _resize_matrix(n_mels, size, dev) @ img
    img = torch.clamp(torch.round(_resize_axis_dynamic(img, n_frames, size)), 0, 255)
    if raw_uint8:
        return img.to(torch.uint8)
    img = (img / 255.0)[..., None].expand(B, size, size, 3)
    mean, std = imagenet_stats(dev)
    return (img - mean) / std


class FeatureAssembler:
    """Raw batch dict -> model inputs on ``device`` (the card unless the
    caller names one), for evaluation or, with ``train``, for training
    (deepfake_tpu/data/pipeline.py:170-253). Keys as the JAX package's
    dataset gives them: ``video`` (uint8 NTHWC), ``audio_image`` (uint8
    NHWC), ``audio_wave`` / ``audio_len`` and ``paudio_wave`` / ``paudio_len``
    (padded PCM and valid lengths). Returns (inputs, labels): a tuple in the
    fused order (video, audio, paudio) for ``fused``, else the one input.

    In training the frames (``video``, ``video_swin`` and the video part of
    ``fused``) are augmented on the device (``ops/image.py``: flips and a
    rotation, one draw a clip unless ``per_frame``) from the assembler's own
    ``torch.Generator`` on ``device``, seeded with ``cfg.random_seed + 1``
    as the JAX assembler seeds its key; and ``batch_longest`` waves are
    normalised per accumulation micro-batch (``cfg.optim.accum_step``
    slices of the batch, the slices the Trainer hands the model). With a
    ``mesh`` the batch is this data rank's rows of a global one: the batch's
    longest wave is taken over every data rank's rows, and the training
    augmentation draws for the whole global batch (one generator state on
    every rank), each clip taking its row's draw, so the mesh augments as
    one device does. A training batch is split over the data axis or
    replicated as ``parallel.mesh.splits_train_batch`` says; an evaluation
    batch takes the caller's ``batch_state`` (split, unless it says
    otherwise)."""

    def __init__(self, cfg: Config, train: bool = False, device=None, per_frame: bool = False,
                 mesh=None):
        from deepfake_tpu_torch.models.registry import resolve_device

        self.cfg = cfg
        self.mesh = mesh
        self.train = train
        self.per_frame = per_frame
        self.modality = cfg.data.modality
        self.device = resolve_device(device)
        self.gen = None
        if train:
            self.gen = torch.Generator(self.device).manual_seed(cfg.random_seed + 1)

    def _get(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return t.to(self.device, dtype)

    def __call__(self, feats, labels):
        if not self.train:  # the caller's batch state: a padded batch splits
            return self._assemble(feats, labels, None)
        split = splits_train_batch(self.cfg, self.mesh)
        rows = None
        if split:  # this data rank's rows of the global batch
            n = len(labels) * self.mesh.data
            rows = n, data_rows(n, self.mesh, max(1, self.cfg.optim.accum_step))
        with batch_state(self.mesh, split):
            return self._assemble(feats, labels, rows)

    def _assemble(self, feats, labels, rows):
        cfg = self.cfg
        out = []
        if "video" in feats:
            out.append(preprocess_clip_batch(self._get(feats["video"]), self.gen, self.per_frame,
                                             rows))
        if "audio_image" in feats:
            out.append(normalize_imagenet(self._get(feats["audio_image"])))
        if "audio_wave" in feats:
            m = cfg.mel
            out.append(mel_image_masked(
                self._get(feats["audio_wave"], torch.float32),
                self._get(feats["audio_len"], torch.long), sr=m.sample_rate, n_fft=m.n_fft,
                hop=m.hop_length, n_mels=m.n_mels, size=cfg.data.audio_size,
                wave_sr=cfg.data.wave_sample_rate))
        if "paudio_wave" in feats:
            wave = self._get(feats["paudio_wave"], torch.float32)
            if cfg.data.wave_norm == "masked":
                out.append(masked_wave_normalize(wave, self._get(feats["paudio_len"], torch.long)))
            elif cfg.data.wave_norm == "batch_longest":
                lengths = self._get(feats["paudio_len"], torch.long)
                # the reference normalises per DataLoader batch, which under
                # accumulation is each micro-batch
                accum = max(1, cfg.optim.accum_step) if self.train else 1
                longest = lambda n: global_max(n.max(), self.mesh)
                if accum > 1 and wave.shape[0] % accum == 0:
                    normed = torch.cat([batch_longest_wave_normalize(w, n, longest(n)) for w, n in
                                        zip(wave.chunk(accum), lengths.chunk(accum))])
                else:
                    normed = batch_longest_wave_normalize(wave, lengths, longest(lengths))
                out.append((normed, lengths))
            else:  # "hf"
                out.append(hf_wave_normalize(wave))
        inputs = tuple(out) if self.modality == "fused" else out[0]
        return inputs, self._get(labels)


class _Slot:
    """One batch's pinned host buffers, by feature key. Only the main thread
    allocates them (``pin``); the producer thread writes into those whose
    shape and type match (``fill``), and leaves the rest to ``pin``."""

    def __init__(self):
        self.pinned: Dict[str, torch.Tensor] = {}
        self.pending: Dict[str, np.ndarray] = {}  # arrays that had no matching buffer
        self.copied: Optional[torch.cuda.Event] = None  # the last copy out of the buffers

    def fill(self, feats) -> None:
        """Producer thread: host copies only, no CUDA call."""
        self.pending = {}
        for k, a in feats.items():
            a = np.asarray(a)
            buf = self.pinned.get(k)
            if buf is not None and tuple(buf.shape) == a.shape and buf.numpy().dtype == a.dtype:
                np.copyto(buf.numpy(), a)
            else:
                self.pending[k] = a

    def pin(self) -> None:
        """Main thread: pinned buffers for the arrays ``fill`` could not place."""
        for k, a in self.pending.items():
            buf = torch.empty(a.shape, dtype=torch.from_numpy(a).dtype, pin_memory=True)
            np.copyto(buf.numpy(), a)
            self.pinned[k] = buf
        self.pending = {}


class DevicePrefetcher:
    """Yields a loader's (feats, labels, names) batches with each feature on
    ``device``, at most ``depth`` batches decoded ahead.

    CUDA calls stay in the thread that iterates: a capture in CUDA's global
    mode fails if another thread allocates pinned or device memory or
    synchronises while it runs, and the first batch's graph is captured
    while the producer is decoding. So the producer thread only decodes,
    collates and copies into pinned buffers that the main thread allocated
    (``_Slot``; a new shape's buffers are allocated by the main thread on
    first sight, and the producer writes into them from then on). The main
    thread issues batch i + 1's host-to-device copies on a side stream
    before it hands out batch i, and makes the current stream wait for them
    before batch i + 1 is handed out; a slot is written again only after
    its copies ran. Labels and names stay on the host. On the CPU the
    batches pass through as they are. A failure in the producer is raised
    in the iterating thread."""

    def __init__(self, loader: Iterable, device, depth: int = 4):
        from deepfake_tpu_torch.models.registry import resolve_device

        self.loader = loader
        self.device = resolve_device(device)
        self.depth = max(1, depth)

    def __len__(self):
        return len(self.loader)

    def __iter__(self) -> Iterator:
        if self.device.type != "cuda":
            yield from self.loader
            return
        slots = [_Slot() for _ in range(self.depth + 2)]
        free: queue.Queue = queue.Queue()
        for s in slots:
            free.put(s)
        ready: queue.Queue = queue.Queue()
        stop = threading.Event()
        end = object()

        def producer():
            try:
                for feats, labels, names in self.loader:
                    slot = free.get()
                    if stop.is_set():
                        return
                    slot.fill(feats)
                    ready.put((slot, labels, names))
            except BaseException as e:  # re-raised in the iterating thread
                ready.put(e)
            finally:
                ready.put(end)

        side = torch.cuda.Stream(self.device)
        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        def stage():
            item = ready.get()
            if item is end:
                return None
            if isinstance(item, BaseException):
                raise item
            slot, labels, names = item
            slot.pin()
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                feats = {k: t.to(self.device, non_blocking=True) for k, t in slot.pinned.items()}
                slot.copied = torch.cuda.Event()
                slot.copied.record(side)
            return slot, feats, labels, names

        try:
            cur = stage()
            while cur is not None:
                nxt = stage()
                slot, feats, labels, names = cur
                torch.cuda.current_stream(self.device).wait_event(slot.copied)
                for t in feats.values():  # allocated on the side stream, used on this one
                    t.record_stream(torch.cuda.current_stream(self.device))
                yield feats, labels, names
                slot.copied.synchronize()
                free.put(slot)
                cur = nxt
        finally:
            stop.set()
            for s in slots:  # unblock a producer waiting for a slot
                free.put(s)
            thread.join(timeout=60)


class ModelFeedLoader:
    """A raw loader -> (inputs, labels) on ``device`` for the Trainer:
    batches through ``DevicePrefetcher`` (``cfg.data.prefetch_depth`` ahead)
    and a ``FeatureAssembler`` (``train`` selects augmentation)."""

    def __init__(self, raw_loader, cfg: Config, train: bool, device=None,
                 depth: Optional[int] = None, mesh=None):
        self.raw = raw_loader
        self.assembler = FeatureAssembler(cfg, train, device=device, mesh=mesh)
        self.depth = depth if depth is not None else cfg.data.prefetch_depth

    def __len__(self):
        return len(self.raw)

    def __iter__(self):
        for feats, labels, _names in DevicePrefetcher(self.raw, self.assembler.device,
                                                      self.depth):
            yield self.assembler(feats, labels)
