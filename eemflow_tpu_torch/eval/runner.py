"""Evaluation engine (counterpart of ``eemflow_tpu/eval/runner.py``;
reference ``test_mvsec.py`` ``Test`` + ``test_multi_sequence:538-671``, and
its research methods in ``ResearchTester``).

Per-sequence loop over a dataset with ``change_test_sequence``;
per-sample EPE accumulates on the host; results are per-sequence AEE and
the mean of the sequence means, with an optional per-sample CSV.  The
forward of the next batch is queued on the device before the flows of the
previous one are fetched, so host work (dataset IO, numpy metrics)
overlaps device work.  ``preprocess`` (if given) runs first on the device
— the device-voxelize path.  The dataset's arrays reach the card as
pageable copies (``data.staging.Staging.upload``: copying them into pinned
buffers first costs the host as much as it saves; ``PERF.md``), and the
flow comes back through a pinned buffer.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from eemflow_tpu_torch.data.staging import Staging
from eemflow_tpu_torch.eval.metrics import flow_error

# sample keys a forward consumes (two volumes, or raw events to voxelize)
_INPUT_KEYS = (
    "event_volume_old", "event_volume_new",
    "events_old", "events_new", "n_old", "n_new",
)


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack the input keys of several samples; arrays whose lengths
    differ only in dim 0 (bucket-laddered event buffers) are zero-padded
    to the batch max."""
    out = {}
    for k in _INPUT_KEYS:
        if k not in samples[0] or samples[0][k] is None:
            continue
        arrs = [np.asarray(s[k]) for s in samples]
        if arrs[0].ndim == 0:
            out[k] = np.stack(arrs)
            continue
        n0 = max(a.shape[0] for a in arrs)
        batch = np.zeros((len(arrs), n0) + arrs[0].shape[1:], arrs[0].dtype)
        for i, a in enumerate(arrs):
            if a.shape[1:] != arrs[0].shape[1:]:
                raise ValueError(f"collate: key '{k}' varies beyond dim 0")
            batch[i, : a.shape[0]] = a
        out[k] = batch
    return out


class Tester:
    """Evaluation engine for the ``two_volume`` family: ``model(ev_old,
    ev_new)`` → ``(maps, [flow, ...])``, final flow [B, H, W, 2].  Each
    sample is scored by ``flow_error`` under the dataset's
    ``evaluation_type`` (dense, or sparse: masked to the sample's
    ``event_valid``), on its first 190 rows only when ``is_car`` (MVSEC's
    outdoor sequences, whose bottom rows show the car's hood)."""

    def __init__(
        self,
        model: torch.nn.Module,
        device: torch.device,
        save_path: Optional[str] = None,
        save_csv: bool = False,
        preprocess=None,
        is_car: bool = False,
    ):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.save_path = save_path
        self.save_csv = save_csv
        self.is_car = is_car
        self._preprocess = preprocess
        self.staging = Staging(self.device)

    @staticmethod
    def _log(line: str) -> None:
        print(line, flush=True)

    def _inputs(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A batch of host arrays → the model's inputs on the device, after
        the device-voxelize step where there is one (call under inference
        mode)."""
        batch = {k: self.staging.upload(np.ascontiguousarray(v)) for k, v in arrays.items()}
        return self._preprocess(batch) if self._preprocess is not None else batch

    def _forward(self, arrays: Dict[str, np.ndarray]):
        """Queue one forward over a batch of host arrays and the copy of
        its flow [B, H, W, 2] to the host; returns the copy's handle
        (``.numpy()`` waits) without waiting for it."""
        with torch.inference_mode():
            batch = self._inputs(arrays)
            _, preds = self.model(batch["event_volume_old"], batch["event_volume_new"])
            return self.staging.fetch(preds[-1].float())

    @staticmethod
    def _arrays(sample) -> Dict[str, np.ndarray]:
        """A sample's input arrays as a batch of one."""
        return {k: np.asarray(sample[k])[None] for k in _INPUT_KEYS if k in sample and sample[k] is not None}

    def _dispatch(self, sample):
        return self._forward(self._arrays(sample))

    def _dispatch_many(self, samples):
        """One batched forward over several samples: every op is
        per-sample, so results equal per-sample dispatch."""
        return self._forward(collate(samples))

    def run_sample(self, sample: Dict[str, np.ndarray]) -> np.ndarray:
        """Single sample dict → flow [H, W, 2]."""
        return self._dispatch(sample).numpy()[0]

    def test_sequence(
        self, dataset, stride: int = 1, max_samples: Optional[int] = None, batch_size: int = 1,
    ) -> Dict[str, float]:
        """Evaluate the dataset's current sequence (every ``stride``-th
        sample, at most ``max_samples`` of them); returns aggregates."""
        AEE_sum = pct1_sum = pct3_sum = 0.0
        iters = 0
        rows = []
        pending = None  # (samples, device flow)
        indices = list(range(0, len(dataset), stride))
        if max_samples is not None:
            indices = indices[:max_samples]
        evaluation_type = getattr(dataset, "evaluation_type", "dense")

        def consume(samples, fut):
            nonlocal AEE_sum, pct1_sum, pct3_sum, iters
            flows = fut.numpy()
            for j, sample in enumerate(samples):
                ev_img = sample.get("event_valid")
                aee, p1, p3, _, _, _, _ = flow_error(
                    np.asarray(sample["flow"]),
                    flows[j],
                    event_img=None if ev_img is None else np.squeeze(ev_img),
                    is_car=self.is_car,
                    evaluation_type=evaluation_type,
                )
                AEE_sum += aee
                pct1_sum += p1
                pct3_sum += p3
                iters += 1
                rows.append([iters, aee])

        for c0 in range(0, len(indices), batch_size):
            samples = [dataset[i] for i in indices[c0 : c0 + batch_size]]
            fut = (
                self._dispatch(samples[0]) if len(samples) == 1
                else self._dispatch_many(samples)
            )
            if pending is not None:
                consume(*pending)
            pending = (samples, fut)
        if pending is not None:
            consume(*pending)
        if self.save_csv and self.save_path is not None:
            os.makedirs(self.save_path, exist_ok=True)
            with open(
                os.path.join(self.save_path, "test_epe_per_sample.csv"), "w", newline=""
            ) as f:
                w = csv.writer(f)
                w.writerow(["index", "epe"])
                w.writerows(rows)
        n = max(iters, 1)
        return {
            "AEE": AEE_sum / n,
            "pct1_outlier": 1.0 - pct1_sum / n,
            "pct3_outlier": 1.0 - pct3_sum / n,
            "n_samples": iters,
        }

    def test_multi_sequence(
        self,
        dataset,
        sequence_list: Sequence[str],
        stride: int = 1,
        max_samples: Optional[int] = None,
        batch_size: int = 1,
    ) -> Dict[str, Dict[str, float]]:
        """Per-sequence eval + mean of per-sequence AEE (the HREM protocol)."""
        results: Dict[str, Dict[str, float]] = {}
        for seq in sequence_list:
            dataset.change_test_sequence(seq)
            t0 = time.time()
            res = self.test_sequence(dataset, stride=stride, max_samples=max_samples,
                                     batch_size=batch_size)
            self._log(
                f"[{seq}] AEE {res['AEE']:.6f}  1px-out {res['pct1_outlier']:.6f}  "
                f"3px-out {res['pct3_outlier']:.6f}  ({res['n_samples']} samples, "
                f"{time.time() - t0:.1f}s)"
            )
            results[seq] = res
        mean_aee = float(np.mean([r["AEE"] for r in results.values()]))
        self._log(f"mean AEE over sequences: {mean_aee:.6f}")
        results["mean"] = {"AEE": mean_aee}
        return results


def _to_uint8(a: np.ndarray) -> np.ndarray:
    """An array stretched to 0..255 (the warp mode's pictures)."""
    a = np.squeeze(a)
    return ((a - a.min()) / (a.max() - a.min() + 1e-8) * 255).astype(np.uint8)


def _density(a) -> float:
    """The share of pixels with any event in an NHWC volume."""
    return float((np.abs(np.asarray(a)).sum(-1) > 0).mean())


class ResearchTester(Tester):
    """The research evaluation modes (counterpart of
    ``eemflow_tpu/eval/runner.py:266-547``; reference ``test_mvsec.py``): flow
    dumps (``test_multi_save_flow``), low-EPE pictures
    (``test_vis_low_epe``), the second volume warped back by the flow
    (``inference_warp``), AEE by event density (``test_multi_density``),
    DSEC submission files (``save_dsec_submission``), the probe-point flow
    error (``inference_warp_loss``) and the key-map density study
    (``test_multi_key``).  Each takes every ``stride``-th sample, at most
    ``max_samples`` of them, and its flow from ``run_sample``, so the
    device-voxelize step and the fused modes reach every mode.  Pictures are
    PNGs (``viz.png``) where the JAX package writes JPEGs.  Under the
    device-voxelize step the modes that read the input volumes (``warp``,
    ``density``) take them from that step, as ``test_multi_key`` does in
    both packages; the JAX package's ``warp`` and ``density`` read the
    host's volumes only."""

    # the CLIs' --mode names: test_hrem takes the first five, test_mvsec all
    MODES = ("save_flow", "low_epe", "warp", "density", "dsec_submission", "warp_loss", "multi_key")

    def run_mode(self, mode: str, dataset, out_dir: str, stride: int = 1, max_samples: Optional[int] = None):
        """The research mode ``mode`` over the dataset's current sequence,
        its pictures and files under ``out_dir``; returns what it returns."""
        kw = dict(stride=stride, max_samples=max_samples)
        runs = {
            "save_flow": lambda: self.test_multi_save_flow(dataset, out_dir, **kw),
            "low_epe": lambda: self.test_vis_low_epe(dataset, out_dir, **kw),
            "warp": lambda: self.inference_warp(dataset, out_dir, **kw),
            "density": lambda: self.test_multi_density(dataset, **kw),
            "dsec_submission": lambda: self.save_dsec_submission(dataset, out_dir, **kw),
            "warp_loss": lambda: self.inference_warp_loss(dataset, **kw),
            "multi_key": lambda: self.test_multi_key(dataset, **kw),
        }
        if mode not in runs:
            raise ValueError(f"unknown research mode {mode!r}; the modes are {', '.join(self.MODES)}")
        return runs[mode]()

    def _aee(self, dataset, sample, flow_est: np.ndarray) -> float:
        ev_img = sample.get("event_valid")
        aee, *_ = flow_error(
            np.asarray(sample["flow"]), flow_est,
            event_img=None if ev_img is None else np.squeeze(np.asarray(ev_img)),
            is_car=self.is_car, evaluation_type=getattr(dataset, "evaluation_type", "dense"),
        )
        return aee

    def _volumes(self, sample):
        """The sample's two input volumes [H, W, bins] on the host: its own,
        or those the device-voxelize step makes from its raw events."""
        if sample.get("event_volume_old") is not None:
            return np.asarray(sample["event_volume_old"]), np.asarray(sample["event_volume_new"])
        with torch.inference_mode():
            batch = self._inputs(self._arrays(sample))
            return tuple(batch[k][0].float().cpu().numpy() for k in ("event_volume_old", "event_volume_new"))

    @staticmethod
    def _samples(dataset, stride: int):
        return ((idx, dataset[idx]) for idx in range(0, len(dataset), stride))

    def test_multi_save_flow(self, dataset, out_dir: str, stride: int = 1,
                             max_samples: Optional[int] = None) -> int:
        """Each sample's flow as ``<idx>.flo`` and its HSV picture
        ``<idx>_flow.png``; returns the count."""
        from eemflow_tpu_torch.events.io import write_flo
        from eemflow_tpu_torch.viz.flow_viz import visualize_optical_flow
        from eemflow_tpu_torch.viz.png import write_png

        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for idx, sample in self._samples(dataset, stride):
            flow_est = self.run_sample(sample)
            write_flo(flow_est, os.path.join(out_dir, f"{idx:06d}.flo"))
            write_png(os.path.join(out_dir, f"{idx:06d}_flow.png"), visualize_optical_flow(flow_est))
            n += 1
            if max_samples is not None and n >= max_samples:
                break
        self._log(f"saved {n} flow predictions to {out_dir}")
        return n

    def test_vis_low_epe(self, dataset, out_dir: str, epe_threshold: float = 1.0, stride: int = 1,
                         max_samples: Optional[int] = None):
        """Pictures of the estimate and the ground truth of each sample whose
        AEE lies below ``epe_threshold``; returns the kept (idx, AEE)."""
        from eemflow_tpu_torch.viz.flow_viz import visualize_optical_flow
        from eemflow_tpu_torch.viz.png import write_png

        os.makedirs(out_dir, exist_ok=True)
        kept = []
        for idx, sample in self._samples(dataset, stride):
            flow_est = self.run_sample(sample)
            aee = self._aee(dataset, sample, flow_est)
            if aee < epe_threshold:
                kept.append((idx, aee))
                write_png(os.path.join(out_dir, f"{idx:06d}_est_epe{aee:.3f}.png"), visualize_optical_flow(flow_est))
                write_png(os.path.join(out_dir, f"{idx:06d}_gt.png"),
                          visualize_optical_flow(np.asarray(sample["flow"])))
            if max_samples is not None and len(kept) >= max_samples:
                break
        self._log(f"{len(kept)} samples below EPE {epe_threshold}")
        return kept

    def inference_warp(self, dataset, out_dir: str, stride: int = 1, max_samples: Optional[int] = None) -> int:
        """The second volume's channel sum warped back by the flow
        (``ops.warp.backwarp`` on the device), written beside the first's:
        ``<idx>_ev1.png``, ``<idx>_ev2_warped.png``; returns the count."""
        from eemflow_tpu_torch.ops.warp import backwarp
        from eemflow_tpu_torch.viz.png import write_png

        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for idx, sample in self._samples(dataset, stride):
            flow_est = self.run_sample(sample)
            ev1, ev2 = self._volumes(sample)
            with torch.inference_mode():
                warped = backwarp(
                    torch.from_numpy(np.ascontiguousarray(ev2.sum(-1, keepdims=True)))[None].to(self.device),
                    torch.from_numpy(flow_est)[None].to(self.device),
                )[0].cpu().numpy()
            write_png(os.path.join(out_dir, f"{idx:06d}_ev1.png"), _to_uint8(ev1.sum(-1)))
            write_png(os.path.join(out_dir, f"{idx:06d}_ev2_warped.png"), _to_uint8(warped))
            n += 1
            if max_samples is not None and n >= max_samples:
                break
        return n

    def test_multi_density(self, dataset, buckets=(0.0, 0.05, 0.15, 0.3, 1.01), stride: int = 1,
                           max_samples: Optional[int] = None):
        """AEE by the first volume's event density (share of active
        pixels): {"[lo,hi)": (mean AEE or nan, count)}."""
        sums = [0.0] * (len(buckets) - 1)
        counts = [0] * (len(buckets) - 1)
        done = 0
        for _, sample in self._samples(dataset, stride):
            density = _density(self._volumes(sample)[0])
            aee = self._aee(dataset, sample, self.run_sample(sample))
            for b in range(len(buckets) - 1):
                if buckets[b] <= density < buckets[b + 1]:
                    sums[b] += aee
                    counts[b] += 1
            done += 1
            if max_samples is not None and done >= max_samples:
                break
        result = {
            f"[{buckets[b]:.2f},{buckets[b + 1]:.2f})": (sums[b] / counts[b] if counts[b] else float("nan"), counts[b])
            for b in range(len(buckets) - 1)
        }
        for k, (aee, cnt) in result.items():
            self._log(f"density {k}: AEE {aee:.4f} ({cnt} samples)")
        return result

    def save_dsec_submission(self, dataset, out_dir: str, stride: int = 1,
                             max_samples: Optional[int] = None) -> int:
        """Each sample's flow as a DSEC 16-bit PNG ``<name>.png`` (reference
        ``DsecFlowVisualizer.visualize_flow_submission``); returns the count."""
        from eemflow_tpu_torch.data.dsec import write_flow_submission

        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for idx, sample in self._samples(dataset, stride):
            flow_est = self.run_sample(sample)
            name = sample.get("names", f"{idx:06d}")
            write_flow_submission(flow_est, os.path.join(out_dir, f"{name}.png"))
            n += 1
            if max_samples is not None and n >= max_samples:
                break
        self._log(f"wrote {n} DSEC submission files to {out_dir}")
        return n

    def inference_warp_loss(self, dataset, stride: int = 10, max_samples: Optional[int] = None) -> float:
        """Probe-point flow error ("FWL", reference ``inference_img_warp_loss``,
        ``test_mvsec.py:753-851``): a sample's mean L2 difference of the
        ground truth and the estimate at the centres of a 4×4 grid of image
        cells; returns the mean over the samples."""
        loss_sum = 0.0
        iters = 0
        for _, sample in self._samples(dataset, stride):
            flow_est = self.run_sample(sample)
            flow_gt = np.asarray(sample["flow"])
            h, w = flow_gt.shape[:2]
            ys = (np.arange(4) + 0.5) * (h // 4)
            xs = (np.arange(4) + 0.5) * (w // 4)
            yy, xx = np.meshgrid(ys.astype(int), xs.astype(int), indexing="ij")
            diff = flow_gt[yy.ravel(), xx.ravel()] - flow_est[yy.ravel(), xx.ravel()]
            loss_sum += float(np.mean(np.linalg.norm(diff, axis=-1)))
            iters += 1
            if max_samples is not None and iters >= max_samples:
                break
        mean_fwl = loss_sum / max(iters, 1)
        self._log(f"Mean FWL: {mean_fwl:.6f} ({iters} samples)")
        return mean_fwl

    def _key_map(self, out) -> torch.Tensor:
        """The first view's finest map in the first element of a model's
        ``(maps, flows)`` output; a model whose output is not of that form
        raises, naming it."""
        name = type(self.model).__name__
        if not (isinstance(out, (tuple, list)) and len(out) == 2 and isinstance(out[1], (tuple, list))):
            raise ValueError(f"test_multi_key: {name} does not return (maps, flows)")
        key_map = out[0]
        if isinstance(key_map, (tuple, list)) and key_map and isinstance(key_map[-1], (tuple, list)):
            key_map = key_map[-1]  # a multi-scale list of pairs → the finest
        if isinstance(key_map, (tuple, list)) and key_map:
            key_map = key_map[0]  # (view 1, view 2) → view 1
        if not isinstance(key_map, torch.Tensor):
            raise ValueError(f"test_multi_key: {name} returns no event map in the first element of its output "
                             f"({type(key_map).__name__})")
        return key_map

    def test_multi_key(self, dataset, stride: int = 1, max_samples: Optional[int] = None):
        """Key-map density study (reference ``test_multi_key``,
        ``test_mvsec.py:854-1005``): per sample the input volume's event
        density, the density of the first view's map in the model's ``maps``
        output (for EEMFlow its input) and the AEE; writes
        ``key_density.csv`` under ``save_path`` (the reference writes xlsx)
        and returns (mean AEE, rows)."""
        rows = []
        AEE_sum = 0.0
        iters = 0
        for idx, sample in self._samples(dataset, stride):
            with torch.inference_mode():
                batch = self._inputs(self._arrays(sample))
                out = self.model(batch["event_volume_old"], batch["event_volume_new"])
                map_den = _density(self._key_map(out).float().cpu())
                ev_den = _density(batch["event_volume_old"].float().cpu())
                flow_est = out[1][-1][0].float().cpu().numpy()
            aee = self._aee(dataset, sample, flow_est)
            rows.append([f"{idx}", ev_den, map_den, f"{aee:.3f}"])
            AEE_sum += aee
            iters += 1
            if max_samples is not None and iters >= max_samples:
                break
        if self.save_path is not None and rows:
            os.makedirs(self.save_path, exist_ok=True)
            with open(os.path.join(self.save_path, "key_density.csv"), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["name", "input", "unet_out", "AEE"])
                w.writerows(rows)
        mean_aee = AEE_sum / max(iters, 1)
        self._log(f"test_multi_key: mean AEE {mean_aee:.6f} ({iters} samples)")
        return mean_aee, rows
