"""Ground-truth encoding conversions: class IDs <-> colors <-> one-hot.

Port of ``fcn8s_tensorflow_tpu/data/conversions.py``: the host (NumPy)
functions are copies; the JAX package's ``jax_*`` device functions become
``torch_*`` functions on tensors, computed on the tensor's device.

The reference's ``convert_IDs_to_IDs_partial`` has a NameError bug (it
references an undefined ``id_map``); this implements the documented
behaviour instead, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side (NumPy)
# ---------------------------------------------------------------------------


def convert_ids_to_ids(image: np.ndarray, id_map: np.ndarray) -> np.ndarray:
    """Vectorized full remap via a LUT array: ``out = id_map[image]``.

    ``id_map``'s indices are current IDs, its values the desired IDs
    (reference `ground_truth_conversion_utils.py:3-24`).
    """
    return np.asarray(id_map)[image]


def convert_ids_to_ids_partial(image: np.ndarray, id_map: dict) -> np.ndarray:
    """Partial remap from a dict ``{current_id: new_id}``; IDs not in the dict
    pass through unchanged (reference `:27-49`, sans its NameError bug)."""
    out = image.copy()
    for cur, new in id_map.items():
        out[image == cur] = new
    return out


def convert_between_ids_and_colors(
    image: np.ndarray, conversion_map: dict, gt_dtype=np.uint8
) -> np.ndarray:
    """Convert between single-channel ID maps and 3-channel color maps in
    either direction, driven by the key/value shapes of ``conversion_map``
    (reference `:52-66`).

    * keys are 3-tuples, values ints  -> color image to ID map
    * keys are ints, values 3-tuples  -> ID map to color image
    """
    sample_key = next(iter(conversion_map))
    if isinstance(sample_key, tuple):  # colors -> IDs
        h, w = image.shape[:2]
        out = np.zeros((h, w), dtype=gt_dtype)
        for color, class_id in conversion_map.items():
            match = np.all(image == np.asarray(color, dtype=image.dtype), axis=-1)
            # modular cast (e.g. license plate id -1 -> 255 in uint8), the
            # historical numpy assignment semantics the reference relied on.
            out[match] = np.asarray(class_id).astype(gt_dtype)
        return out
    # IDs -> colors
    h, w = image.shape[:2]
    out = np.zeros((h, w, 3), dtype=gt_dtype)
    for class_id, color in conversion_map.items():
        out[image == class_id] = np.asarray(color, dtype=gt_dtype)
    return out


def convert_ids_to_colors(image: np.ndarray, color_lut: np.ndarray) -> np.ndarray:
    """ID map -> color image via an ``(num_ids, 3)`` LUT array (reference `:69-75`)."""
    return np.asarray(color_lut)[image]


def convert_one_hot_to_ids(one_hot: np.ndarray) -> np.ndarray:
    """One-hot (..., C) -> integer ID map via argmax (reference `:78-80`)."""
    return np.argmax(one_hot, axis=-1)


def convert_ids_to_one_hot(image: np.ndarray, num_classes: int, dtype=np.int32) -> np.ndarray:
    """Integer ID map -> one-hot (..., C) via an identity-row gather
    (reference `:83-88` uses ``np.eye(num_classes, dtype=bool)`` row-gather)."""
    eye = np.eye(num_classes, dtype=bool)
    return eye[image].astype(dtype)


# ---------------------------------------------------------------------------
# Device-side (PyTorch), on the tensor's device
# ---------------------------------------------------------------------------


def _lut(table, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(table), device=device)


def torch_convert_ids_to_ids(image: torch.Tensor, id_map) -> torch.Tensor:
    """LUT remap ``id_map[image]`` on ``image``'s device; the result has the
    LUT's dtype, as ``jnp.asarray(id_map)[image]`` has."""
    return _lut(id_map, image.device)[image.long()]


def torch_convert_ids_to_one_hot(image: torch.Tensor, num_classes: int,
                                 dtype=torch.float32) -> torch.Tensor:
    """One-hot (..., C) by comparing each id with ``arange(num_classes)``,
    so an id outside [0, num_classes) gives an all-zero row."""
    classes = torch.arange(num_classes, dtype=image.dtype, device=image.device)
    return (image[..., None] == classes).to(dtype)


def torch_convert_ids_to_colors(image: torch.Tensor, color_lut) -> torch.Tensor:
    """ID map -> (..., 3) colours through an ``(num_ids, 3)`` LUT."""
    return _lut(color_lut, image.device)[image.long()]
