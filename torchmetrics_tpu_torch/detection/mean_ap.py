# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Mean average precision module metric (counterpart of ``torchmetrics_tpu/detection/mean_ap.py``).

The states are the JAX package's list states, one entry per image: boxes
(float32), scores (float32), labels, crowd flags (int32) and areas
(float32) as tensors on the metric's device, and masks as RLE dicts
(encoded by the port's native codec at update). ``compute`` runs
:func:`~torchmetrics_tpu_torch.functional.detection.map.coco_mean_average_precision`
on the metric's device: its greedy matching is the hand kernel K6.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.detection.helpers import _input_validator, _validate_iou_type_arg
from torchmetrics_tpu_torch.functional.detection.map import (
    DEFAULT_IOU_THRESHOLDS,
    DEFAULT_MAX_DETECTIONS,
    DEFAULT_REC_THRESHOLDS,
    _boxes_to_xyxy,
    _host_arrays,
    coco_mean_average_precision,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _to_tensor
from torchmetrics_tpu_torch.utilities.distributed import gather_all_tensors

Tensor = torch.Tensor


class MeanAveragePrecision(Metric):
    """COCO-style mean average precision and recall for object detection.

    Per-image dict inputs (``boxes``/``scores``/``labels`` for
    ``iou_type="bbox"``, ``masks`` for ``"segm"``; targets may add
    ``iscrowd``/``area``); result keys ``map``, ``map_50``, ``map_75``,
    ``map_small/medium/large``, ``mar_{k}``, ``mar_small/medium/large``,
    ``map_per_class``, ``mar_{k}_per_class``, ``classes``.

    ``iou_type="segm"`` encodes masks through the native RLE codec at update
    and matches on the RLE IoU matrices. The mixed ``("bbox", "segm")``
    tuple runs both evaluations over one stream and prefixes every result
    key but ``classes`` with the IoU type; ground truths then bin by their
    positive user area, else their mask area, in both passes, and
    detections by the pass's geometry. ``backend`` is accepted and kept, as
    the JAX package keeps it; nothing reads it.
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: Union[str, Tuple[str, ...]] = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        extended_summary: bool = False,
        average: str = "macro",
        backend: str = "jax",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_type = _validate_iou_type_arg(iou_type)
        if len(set(self.iou_type)) != len(self.iou_type):
            raise ValueError(f"Expected argument `iou_type` to contain no duplicates, but got {iou_type}")
        if iou_thresholds is not None and not isinstance(iou_thresholds, list):
            raise ValueError(
                f"Expected argument `iou_thresholds` to either be `None` or a list of floats but got {iou_thresholds}"
            )
        self.iou_thresholds = list(iou_thresholds or DEFAULT_IOU_THRESHOLDS)
        if rec_thresholds is not None and not isinstance(rec_thresholds, list):
            raise ValueError(
                f"Expected argument `rec_thresholds` to either be `None` or a list of floats but got {rec_thresholds}"
            )
        self.rec_thresholds = list(rec_thresholds or DEFAULT_REC_THRESHOLDS)
        if max_detection_thresholds is not None and not isinstance(max_detection_thresholds, list):
            raise ValueError(
                f"Expected argument `max_detection_thresholds` to either be `None` or a list of ints"
                f" but got {max_detection_thresholds}"
            )
        if max_detection_thresholds is not None and len(max_detection_thresholds) != 3:
            raise ValueError(
                "When providing a list of max detection thresholds it should have length 3."
                f" Got value {len(max_detection_thresholds)}"
            )
        self.max_detection_thresholds = sorted(max_detection_thresholds or DEFAULT_MAX_DETECTIONS)
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        if not isinstance(extended_summary, bool):
            raise ValueError("Expected argument `extended_summary` to be a boolean")
        self.extended_summary = extended_summary
        if average not in ("macro", "micro"):
            raise ValueError(f"Expected argument `average` to be one of ('macro', 'micro') but got {average}")
        self.average = average
        self.backend = backend

        self.add_state("detection_box", default=[], dist_reduce_fx=None)
        self.add_state("detection_mask", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_mask", default=[], dist_reduce_fx=None)
        self.add_state("detection_scores", default=[], dist_reduce_fx=None)
        self.add_state("detection_labels", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_box", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_crowds", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_area", default=[], dist_reduce_fx=None)

    @property
    def _is_segm(self) -> bool:
        return "segm" in self.iou_type

    @property
    def _is_bbox(self) -> bool:
        return "bbox" in self.iou_type

    def update(self, preds: Sequence[Dict[str, Any]], target: Sequence[Dict[str, Any]]) -> None:
        """Append each image's detections and ground truths.

        Masks are RLE-encoded here (compressed ``counts`` strings decoded),
        so the state holds run lengths, not dense masks. With the mixed
        tuple both geometries are stored.
        """
        _input_validator(preds, target, iou_type=self.iou_type)
        segm, bbox = self._is_segm, self._is_bbox
        dev = self._device
        if segm:
            from torchmetrics_tpu_torch.functional.detection import mask_utils

        def _to_rle_list(masks):
            if isinstance(masks, Tensor):
                masks = masks.detach().cpu().numpy()  # one copy for the image, not one a mask
            out = []
            for m in masks:
                if isinstance(m, dict):
                    counts = m["counts"]
                    if isinstance(counts, (str, bytes)):  # pycocotools' compressed RLE
                        counts = mask_utils.rle_from_string(counts)
                    out.append({"size": list(m["size"]), "counts": np.asarray(counts, np.uint32)})
                else:
                    out.append(mask_utils.encode(m))
            return out

        for item in preds:
            if segm:
                self.detection_mask.append(_to_rle_list(item["masks"]))
            if bbox:
                self.detection_box.append(_to_tensor(item["boxes"], dev).to(torch.float32).reshape(-1, 4))
            self.detection_scores.append(_to_tensor(item["scores"], dev).to(torch.float32).reshape(-1))
            self.detection_labels.append(_to_tensor(item["labels"], dev).to(torch.int32).reshape(-1))
        for item in target:
            labels = _to_tensor(item["labels"], dev)
            n = labels.numel()
            if segm:
                self.groundtruth_mask.append(_to_rle_list(item["masks"]))
            if bbox:
                self.groundtruth_box.append(_to_tensor(item["boxes"], dev).to(torch.float32).reshape(-1, 4))
            self.groundtruth_labels.append(labels.to(torch.int32).reshape(-1))
            crowds = item.get("iscrowd")
            self.groundtruth_crowds.append(
                _to_tensor(crowds, dev).to(torch.int32).reshape(-1)
                if crowds is not None
                else torch.zeros(n, dtype=torch.int32, device=dev)
            )
            area = item.get("area")
            self.groundtruth_area.append(
                _to_tensor(area, dev).to(torch.float32).reshape(-1)
                if area is not None
                else torch.zeros(0, dtype=torch.float32, device=dev)
            )

    def _target_bin_areas(self, geometry: str) -> List[np.ndarray]:
        """Each image's ground-truth bin areas: the user's value where
        positive, else the geometry's (``"segm"``: the RLE mask area, which
        the mixed mode uses in both passes; ``"bbox"``: the box area)."""
        if geometry == "segm":
            from torchmetrics_tpu_torch.functional.detection import mask_utils
        else:
            boxes_h = _host_arrays(self.groundtruth_box, np.float64)
        user_h = _host_arrays(self.groundtruth_area, np.float64)
        areas = []
        for i, ua in enumerate(user_h):
            if geometry == "segm":
                gt_masks = self.groundtruth_mask[i]
                geom = np.asarray(mask_utils.area(gt_masks), np.float64).reshape(-1) if gt_masks else np.zeros(0)
            else:
                boxes = _boxes_to_xyxy(boxes_h[i], self.box_format)
                geom = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            ua = ua.reshape(-1)
            if ua.size == geom.size and ua.size:
                geom = np.where(ua > 0, ua, geom)
            areas.append(geom)
        return areas

    def compute(self) -> Dict[str, Tensor]:
        """The COCO evaluation over the accumulated stream, on the metric's
        device: one pass per IoU type; with the mixed tuple each key but
        ``classes`` gets an ``{iou_type}_`` prefix."""
        mixed = len(self.iou_type) > 1
        # the mixed mode bins ground truths by mask area in both passes; a
        # single type by its own geometry, always with the positive user area first
        fixed_areas = self._target_bin_areas("segm") if mixed else None
        results: Dict[str, Tensor] = {}
        classes = None
        for i_type in self.iou_type:
            prefix = f"{i_type}_" if mixed else ""
            segm = i_type == "segm"
            geom_key = "masks" if segm else "boxes"
            det_geom = self.detection_mask if segm else self.detection_box
            gt_geom = self.groundtruth_mask if segm else self.groundtruth_box
            areas = fixed_areas if mixed else self._target_bin_areas(i_type)
            preds = [
                {geom_key: g, "scores": s, "labels": lab}
                for g, s, lab in zip(det_geom, self.detection_scores, self.detection_labels)
            ]
            target = [
                {geom_key: g, "labels": lab, "iscrowd": c, "area": areas[i]}
                for i, (g, lab, c) in enumerate(zip(gt_geom, self.groundtruth_labels, self.groundtruth_crowds))
            ]
            res = coco_mean_average_precision(
                preds,
                target,
                box_format=self.box_format,
                iou_thresholds=self.iou_thresholds,
                rec_thresholds=self.rec_thresholds,
                max_detection_thresholds=self.max_detection_thresholds,
                class_metrics=self.class_metrics,
                extended_summary=self.extended_summary,
                average=self.average,
                iou_type=i_type,
                device=self._device,
            )
            if not mixed:
                return res
            classes = res.pop("classes")
            for key, val in res.items():
                results[prefix + key] = val
        results["classes"] = classes
        return results

    def _sync_dist(self, dist_sync_fn=gather_all_tensors, process_group=None) -> None:
        """Tensor states take the base gather; the RLE mask states (dicts,
        not tensors) take the object gather, merged as the base merges list
        states, interleaved by element index (``[r0_img0, r1_img0, r0_img1,
        ...]``), so each mask stays beside its scores and labels."""
        from torchmetrics_tpu_torch.utilities.distributed import gather_all_objects

        mask_states = {}
        for attr in ("detection_mask", "groundtruth_mask"):
            mask_states[attr] = getattr(self, attr)
            setattr(self, attr, [])  # hidden from the tensor gather
        try:
            super()._sync_dist(dist_sync_fn=dist_sync_fn, process_group=process_group)
        finally:
            for attr, local in mask_states.items():
                gathered = gather_all_objects(local, self.process_group if process_group is None else process_group)
                merged: list = []
                for i in range(max((len(pm) for pm in gathered), default=0)):
                    for proc_masks in gathered:
                        if i < len(proc_masks):
                            merged.append(proc_masks[i])
                setattr(self, attr, merged)

    @staticmethod
    def coco_to_tm(
        coco_preds: str,
        coco_target: str,
        iou_type: Union[str, Tuple[str, ...]] = "bbox",
        backend: str = "jax",
    ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
        """Read COCO-format json files into this metric's input dicts (numpy arrays).

        ``coco_target`` is a COCO dataset file (``images`` and
        ``annotations``); ``coco_preds`` a results file (an annotation list,
        or a dict with ``annotations``). Boxes go from xywh to xyxy;
        polygons are rasterized by the codec; a missing geometry is derived
        as pycocotools' ``loadRes`` derives it.
        """
        import json

        from torchmetrics_tpu_torch.functional.detection import mask_utils

        iou_type = _validate_iou_type_arg(iou_type)
        segm = "segm" in iou_type
        bbox = "bbox" in iou_type
        with open(coco_target) as f:
            gt_data = json.load(f)
        with open(coco_preds) as f:
            pred_data = json.load(f)
        if isinstance(pred_data, dict):
            pred_data = pred_data.get("annotations", [])

        image_ids = [img["id"] for img in gt_data.get("images", [])]
        img_sizes = {
            img["id"]: (img["height"], img["width"])
            for img in gt_data.get("images", [])
            if "height" in img and "width" in img
        }
        if not image_ids:
            image_ids = sorted({a["image_id"] for a in gt_data.get("annotations", [])})

        def _parse_segmentation(a):
            """An annotation's segmentation as an RLE dict, or None if it has none."""
            seg = a.get("segmentation")
            if seg is None:
                return None
            if isinstance(seg, list):
                img_meta = img_sizes.get(a["image_id"])
                if img_meta is None:
                    raise ValueError(
                        "Polygon segmentations need image height/width in the target file's"
                        f" images entry for image_id {a['image_id']!r}."
                    )
                return mask_utils.from_polygons(seg, img_meta[0], img_meta[1])
            counts = seg["counts"]
            if isinstance(counts, (str, bytes)):
                counts = mask_utils.rle_from_string(counts)
            return {"size": seg["size"], "counts": np.asarray(counts, np.uint32)}

        def group(annotations, with_scores):
            by_img: Dict[Any, Dict[str, list]] = {
                i: {"boxes": [], "labels": [], "scores": [], "crowds": [], "area": [], "masks": []} for i in image_ids
            }
            for ann in annotations:
                entry = by_img.get(ann["image_id"])
                if entry is None:
                    raise ValueError(
                        f"Annotation references image_id {ann['image_id']!r} which is not in the target"
                        " file's image list — mismatched prediction/target files?"
                    )
                rle = _parse_segmentation(ann) if (segm or "bbox" not in ann) else None
                if segm:
                    if rle is None:
                        # loadRes gives a box-only segm result the box's rectangle polygon
                        if "bbox" not in ann:
                            raise ValueError(
                                f"Annotation for image_id {ann['image_id']!r} has neither"
                                " 'segmentation' nor 'bbox'; cannot build masks."
                            )
                        img_meta = img_sizes.get(ann["image_id"])
                        if img_meta is None:
                            raise ValueError(
                                "Deriving a mask from a bare bbox needs image height/width in the"
                                f" target file's images entry for image_id {ann['image_id']!r}."
                            )
                        x, y, w, h = ann["bbox"]
                        rle = mask_utils.from_polygons(
                            [[x, y, x, y + h, x + w, y + h, x + w, y]], img_meta[0], img_meta[1]
                        )
                    entry["masks"].append(rle)
                if bbox:
                    if "bbox" in ann:
                        x, y, w, h = ann["bbox"]
                    elif rle is not None:
                        x, y, w, h = mask_utils.to_bbox(rle).tolist()  # loadRes' rleToBbox
                    else:
                        raise ValueError(
                            f"Annotation for image_id {ann['image_id']!r} has no 'bbox' and no"
                            " segmentation to derive one from."
                        )
                    entry["boxes"].append([x, y, x + w, y + h])
                entry["labels"].append(ann["category_id"])
                entry["crowds"].append(ann.get("iscrowd", 0))
                entry["area"].append(ann.get("area"))
                if with_scores:
                    entry["scores"].append(ann.get("score", 1.0))
            out = []
            for i in image_ids:
                e = by_img[i]
                item: Dict[str, Any] = {"labels": np.asarray(e["labels"], np.int64)}
                if segm:
                    item["masks"] = e["masks"]
                if bbox:
                    item["boxes"] = np.asarray(e["boxes"], np.float64).reshape(-1, 4)
                if with_scores:
                    item["scores"] = np.asarray(e["scores"], np.float64)
                else:
                    item["iscrowd"] = np.asarray(e["crowds"], np.int64)
                    if any(a is not None for a in e["area"]):
                        # a missing area comes from the geometry, so mixed
                        # files keep their small/medium/large bins
                        filled = []
                        for j, a in enumerate(e["area"]):
                            if a is not None:
                                filled.append(float(a))
                            elif segm:
                                filled.append(float(mask_utils.area(e["masks"][j])))
                            else:
                                b = e["boxes"][j]
                                filled.append(float((b[2] - b[0]) * (b[3] - b[1])))
                        item["area"] = np.asarray(filled, np.float64)
                out.append(item)
            return out

        return group(pred_data, True), group(gt_data.get("annotations", []), False)

    def tm_to_coco(self, name: str = "tm_map_input") -> None:
        """Write the accumulated stream as COCO-format json files
        ``{name}_preds.json`` and ``{name}_target.json``."""
        import json

        from torchmetrics_tpu_torch.functional.detection import mask_utils

        segm, bbox = self._is_segm, self._is_bbox
        gt_labels_h = _host_arrays(self.groundtruth_labels, np.int64)
        crowds_h = _host_arrays(self.groundtruth_crowds, np.int64)
        areas_h = _host_arrays(self.groundtruth_area, np.float64)
        scores_h = _host_arrays(self.detection_scores, np.float64)
        det_labels_h = _host_arrays(self.detection_labels, np.int64)
        if bbox:
            gt_boxes_h = _host_arrays(self.groundtruth_box, np.float64)
            det_boxes_h = _host_arrays(self.detection_box, np.float64)

        images = []
        gt_annotations = []
        pred_annotations = []
        ann_id = 1
        for i in range(len(self.groundtruth_labels)):
            image_entry: Dict[str, Any] = {"id": i}
            if segm:
                for rle_list in (self.groundtruth_mask[i], self.detection_mask[i]):
                    if rle_list:
                        image_entry["height"], image_entry["width"] = (int(v) for v in rle_list[0]["size"])
                        break
            images.append(image_entry)
            labels, crowds, areas = gt_labels_h[i], crowds_h[i], areas_h[i]
            gt_boxes_xyxy = _boxes_to_xyxy(gt_boxes_h[i], self.box_format) if bbox else None
            det_boxes_xyxy = _boxes_to_xyxy(det_boxes_h[i], self.box_format) if bbox else None
            for j in range(labels.size):
                ann: Dict[str, Any] = {
                    "id": ann_id,
                    "image_id": i,
                    "category_id": int(labels[j]),
                    "iscrowd": int(crowds[j]) if crowds.size else 0,
                }
                # the user's area where positive, else the geometry's, as compute() bins
                ua = float(areas[j]) if areas.size else 0.0
                if segm:
                    rle = self.groundtruth_mask[i][j]
                    ann["segmentation"] = {"size": list(rle["size"]), "counts": np.asarray(rle["counts"]).tolist()}
                    ann["area"] = ua if ua > 0 else float(mask_utils.area(rle))
                if bbox:
                    box = gt_boxes_xyxy[j]
                    ann["bbox"] = [float(box[0]), float(box[1]), float(box[2] - box[0]), float(box[3] - box[1])]
                    if "area" not in ann:  # the mixed mode keeps the mask-area fallback
                        ann["area"] = ua if ua > 0 else float((box[2] - box[0]) * (box[3] - box[1]))
                gt_annotations.append(ann)
                ann_id += 1
            scores, det_labels = scores_h[i], det_labels_h[i]
            for j in range(det_labels.size):
                ann = {"image_id": i, "category_id": int(det_labels[j]), "score": float(scores[j])}
                if segm:
                    rle = self.detection_mask[i][j]
                    ann["segmentation"] = {"size": list(rle["size"]), "counts": np.asarray(rle["counts"]).tolist()}
                if bbox:
                    box = det_boxes_xyxy[j]
                    ann["bbox"] = [float(box[0]), float(box[1]), float(box[2] - box[0]), float(box[3] - box[1])]
                pred_annotations.append(ann)
        categories = [{"id": int(c)} for c in sorted({a["category_id"] for a in gt_annotations + pred_annotations})]
        with open(f"{name}_target.json", "w") as f:
            json.dump({"images": images, "annotations": gt_annotations, "categories": categories}, f)
        with open(f"{name}_preds.json", "w") as f:
            json.dump(pred_annotations, f)

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)
