"""Evaluation engine (counterpart of ``eemflow_tpu/eval/runner.py:32-272``;
reference ``test_mvsec.py`` ``Test`` + ``test_multi_sequence:538-671``).

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

    def _forward(self, arrays: Dict[str, np.ndarray]):
        """Queue one forward over a batch of host arrays and the copy of
        its flow [B, H, W, 2] to the host; returns the copy's handle
        (``.numpy()`` waits) without waiting for it."""
        batch = {k: self.staging.upload(np.ascontiguousarray(v)) for k, v in arrays.items()}
        with torch.inference_mode():
            if self._preprocess is not None:
                batch = self._preprocess(batch)
            _, preds = self.model(batch["event_volume_old"], batch["event_volume_new"])
            return self.staging.fetch(preds[-1].float())

    def _dispatch(self, sample):
        return self._forward({
            k: np.asarray(sample[k])[None]
            for k in _INPUT_KEYS
            if k in sample and sample[k] is not None
        })

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
