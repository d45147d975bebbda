"""The research visualizers and the train-loop hook (counterpart of
``eemflow_tpu/viz/visualizer.py``; reference ``utils/visualization.py:96-160``,
``utils_luo/tools.py:2366-2371, 2544-2599``, ``train_mvsec.py:263-276``).

  * ``events_overlay_image`` — events over an image, a majority vote of the
    polarities a pixel (negative red, positive blue; BGR);
  * ``flow_error_image`` — the KITTI devkit's log-colour error map;
  * ``create_gif`` — frames to a GIF through ``imageio`` where it imports
    (False where it does not);
  * ``FlowVisualizerEvents`` — a visualized sample's pictures: the masked
    ground truth, the estimate at the ground truth's colour scale, the
    masked estimate, the event overlay and the error map;
  * ``make_train_viz_hook`` — the reference's every-100-steps dump for
    ``train.trainer.Trainer(viz_hook=)``.

Pictures are PNGs (``viz.png``): where the JAX package writes ``name.jpg``
through cv2, the port writes ``name.png`` with the same stem and pixels.
Where the estimate and the ground truth differ in size (EEMFlow's eval
forward against the 16×16 meshflow label in meshflow training), the masked
estimate and the error map, which compare them pixel for pixel, are not
written.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from eemflow_tpu_torch.viz.flow_viz import flow_to_image
from eemflow_tpu_torch.viz.png import write_png


def events_overlay_image(
    events: np.ndarray, height: int, width: int, background: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[N, 4] (t, x, y, p) events over a background image → BGR uint8: red
    where the negative events at a pixel are at least as many as the
    positive ones and there is one, blue where the positive ones are more."""
    if background is None:
        img = np.full((height, width, 3), 255, np.uint8)
    else:
        bg = np.asarray(background)
        if bg.ndim == 2:
            bg = np.tile(bg[..., None], (1, 1, 3))
        bg = bg - bg.min()
        img = np.ascontiguousarray((bg / max(bg.max(), 1e-8) * 255).astype(np.uint8))
    neg_mask = events[:, 3] == -1.0
    span = [[0, width], [0, height]]
    pos, _, _ = np.histogram2d(events[~neg_mask, 1], events[~neg_mask, 2], bins=(width, height), range=span)
    neg, _, _ = np.histogram2d(events[neg_mask, 1], events[neg_mask, 2], bins=(width, height), range=span)
    img[((neg >= pos) & (neg != 0)).T] = (0, 0, 255)
    img[(pos > neg).T] = (255, 0, 0)
    return img


# the KITTI devkit's log-colour map: (lo, hi, r, g, b) an error band
_KITTI_COLORMAP = np.asarray(
    [
        [0, 0.0625, 49, 54, 149],
        [0.0625, 0.125, 69, 117, 180],
        [0.125, 0.25, 116, 173, 209],
        [0.25, 0.5, 171, 217, 233],
        [0.5, 1, 224, 243, 248],
        [1, 2, 254, 224, 144],
        [2, 4, 253, 174, 97],
        [4, 8, 244, 109, 67],
        [8, 16, 215, 48, 39],
        [16, 1e9, 165, 0, 38],
    ],
    np.float32,
)


def flow_error_image(
    flow_pred: np.ndarray,
    flow_gt: np.ndarray,
    mask_occ: np.ndarray,
    mask_noc: Optional[np.ndarray] = None,
    log_colors: bool = True,
) -> np.ndarray:
    """KITTI-style flow error picture → BGR float in [0, 1].  ``mask_occ``:
    [H, W, 1], 1 at valid pixels; ``mask_noc``: 1 only at valid
    non-occluded pixels (all ones by default)."""
    h, w, _ = flow_pred.shape
    mask_occ = np.asarray(mask_occ, np.float32).reshape(h, w, 1)
    mask_noc = (np.ones_like(mask_occ) if mask_noc is None
                else np.asarray(mask_noc, np.float32).reshape(h, w, 1))
    diff = np.sqrt(np.sum((flow_pred - flow_gt) ** 2, axis=2, keepdims=True))
    if log_colors:
        cmap = _KITTI_COLORMAP.copy()
        cmap[:, 2:5] /= 255.0
        mag = np.sqrt(np.sum(flow_gt**2, axis=2, keepdims=True))
        error = np.minimum(diff / 3, 20 * diff / (mag + 1e-7))
        im = np.zeros((h, w, 3), np.float32)
        for lo, hi, r, g, b in cmap:
            cond = (error >= lo) & (error < hi)
            im = np.where(np.tile(cond, (1, 1, 3)), np.asarray([r, g, b]), im)
        im = np.where(np.tile(mask_noc == 1, (1, 1, 3)), im, im * 0.5)
        im = im * mask_occ
    else:
        error = (np.minimum(diff, 5) / 5) * mask_occ
        im = np.concatenate([error, error * mask_noc, error * mask_noc], axis=2)
    return im[:, :, ::-1]


def create_gif(frames: Sequence[np.ndarray], gif_path: str, duration: float = 0.5) -> bool:
    """Write uint8 frames as a GIF; False where ``imageio`` is not
    installed."""
    try:
        import imageio
    except ImportError:
        return False
    imageio.mimsave(gif_path, list(frames), "GIF", duration=duration)
    return True


class FlowVisualizerEvents:
    """A visualized sample's pictures under the reference's names, the
    estimate coloured at the ground truth's scale unless ``clamp_flow`` is
    off."""

    def __init__(self, save_path: str, clamp_flow: bool = True):
        self.save_path = save_path
        self.clamp_flow = clamp_flow
        os.makedirs(save_path, exist_ok=True)

    def _write(self, name: str, img: np.ndarray) -> None:
        write_png(os.path.join(self.save_path, name), img)

    def visualize_sample(
        self,
        idx,
        flow_gt: Optional[np.ndarray] = None,
        flow_est: Optional[np.ndarray] = None,
        valid: Optional[np.ndarray] = None,
        events: Optional[np.ndarray] = None,
        image: Optional[np.ndarray] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
    ) -> None:
        max_flow = None
        if flow_gt is not None:
            gt = np.asarray(flow_gt, np.float32).copy()
            if valid is not None:
                gt[np.asarray(valid) < 0.5] = 0.0
            max_flow = float(np.sqrt((gt**2).sum(-1)).max())
            self._write(f"{idx}_flow_gt.png", flow_to_image(gt))
        # the pictures that compare the estimate with the mask pixel for pixel
        same_grid = valid is not None and flow_est is not None and np.shape(flow_est)[:2] == np.shape(valid)[:2]
        if flow_est is not None:
            est = np.asarray(flow_est, np.float32)
            scale = max_flow if self.clamp_flow else None
            self._write(f"{idx}_flow_est.png", flow_to_image(est, scale))
            if same_grid:
                masked = est.copy()
                masked[np.asarray(valid) < 0.5] = 0.0
                self._write(f"{idx}_flow_est_masked.png", flow_to_image(masked, scale))
        if events is not None:
            h = height or (flow_gt.shape[0] if flow_gt is not None else None)
            w = width or (flow_gt.shape[1] if flow_gt is not None else None)
            if h and w:
                self._write(f"{idx}_events.png", events_overlay_image(np.asarray(events), h, w, image))
        if flow_gt is not None and same_grid and np.shape(flow_gt)[:2] == np.shape(flow_est)[:2]:
            err = flow_error_image(np.asarray(flow_est, np.float32), np.asarray(flow_gt, np.float32),
                                   np.asarray(valid, np.float32)[..., None])
            self._write(f"{idx}_error.png", (err * 255).astype(np.uint8))


def _normalize_map(m: np.ndarray) -> np.ndarray:
    m = m - m.min()
    return (m / max(m.max(), 1e-8) * 255).astype(np.uint8)


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def make_train_viz_hook(save_path: str, model: Optional[torch.nn.Module] = None, family="two_volume",
                        preprocess=None) -> Callable:
    """A ``Trainer`` viz hook: at its call, sample 0's ground truth, the
    model's estimate and the channel sums of the two input volumes (reference
    ``train_mvsec.py:263-276``).  The estimate is a forward in eval mode
    under ``torch.no_grad()`` on the logged batch, after the step (the model
    goes back to train mode after it); ``preprocess`` (the device-voxelize
    step) runs on the batch first, as in the train step."""
    from eemflow_tpu_torch.train.adapters import get_family

    viz = FlowVisualizerEvents(save_path)
    fam = get_family(family)

    def hook(state, batch, iters) -> None:
        with torch.no_grad():
            if preprocess is not None:
                batch = preprocess(batch)
            flow_est = None
            if model is not None:
                training = model.training
                model.eval()
                try:
                    flow_est = _host(fam.flow_est(model(*fam.model_args(batch)))[0])
                finally:
                    model.train(training)
        flow_gt = _host(batch["flow"][0]) if "flow" in batch else None
        valid = _host(batch["valid"][0]) if "valid" in batch else None
        viz.visualize_sample(iters, flow_gt=flow_gt, flow_est=flow_est, valid=valid)
        for key, tag in (("event_volume_old", "map1"), ("event_volume_new", "map2")):
            ev = batch.get(key)
            if ev is not None:
                m = _normalize_map(np.abs(_host(ev[0])).sum(-1))
                write_png(os.path.join(save_path, f"{iters}_{tag}.png"), np.tile(m[..., None], (1, 1, 3)))

    return hook
