"""TF SavedModel interop: export a trained model into the reference's
ecosystem, and read one back. Port of ``tools/tf_interop.py``.

* ``export_tf_savedmodel``: a checkpoint directory written by either
  package (its config read from the manifest), or the port's live params,
  as a TF SavedModel with a ``serving_default`` signature (uint8 RGB image
  -> fp32 logits + int32 argmax ids), built on the parity harness's
  layer-exact TF graph (``tools/parity_harness.py``). Consumable by TF
  Serving, TF-Lite conversion or any TF pipeline.
* ``load_tf_savedmodel_params``: a SavedModel from this exporter (or any
  Keras save of the harness graph) back into the port's param tree on
  ``device`` (default the card). A full TF1 reference training checkpoint
  carries the decoder under the variable names of
  ``REFERENCE_DECONV_NAMES``.

TensorFlow runs on the host's CPU and is imported inside the functions
(``ImportError`` naming ``tensorflow`` where it is not installed).

    python -m fcn8s_tensorflow_tpu_torch.tools.tf_interop export <checkpoint_dir> <out_dir>
"""

from __future__ import annotations

import sys

import numpy as np

from .parity_harness import build_tf_reference_model, copy_params_to_tf

# our decoder layer name -> the reference TF1 graph's variable prefix
REFERENCE_DECONV_NAMES = {
    "pool3_1x1": "pool3_1x1",
    "pool4_1x1": "pool4_1x1",
    "fc7_1x1": "fc7_1x1",
    "fc7_deconv": "fc7_conv2d_trans",
    "fc7_pool4_deconv": "fc7_pool4_conv2d_trans",
    "fc7_pool4_pool3_deconv": "fc7_pool4_pool3_conv2d_trans",
}


def _load_params(checkpoint_dir: str):
    """Checkpoint dir (either package's) -> (the port's tree on the CPU,
    model_config dict)."""
    from .. import bridge
    from ..engine import checkpoint as ckpt

    tree, meta = ckpt.load_params_tree(checkpoint_dir)
    return bridge.to_port(tree), meta["model_config"]


def export_tf_savedmodel(source, out_dir: str, *, num_classes=None, width_mult=1.0,
                         fc_channels=None, variant=None) -> str:
    """Write a TF SavedModel. ``source``: a checkpoint directory (the
    config is read from its manifest) or the port's params tree (then pass
    ``num_classes``; ``variant`` defaults to the decoder's key set). All
    three FCN variants export. Returns ``out_dir``."""
    import tensorflow as tf

    from ..models.fcn8s import decoder_variant

    if isinstance(source, str):
        params, cfg = _load_params(source)
        num_classes = cfg["num_classes"]
        width_mult = cfg.get("width_mult", 1.0)
        fc_channels = cfg.get("fc_channels")
        variant = cfg.get("variant", "fcn8s")
    else:
        params = source
        if num_classes is None:
            raise ValueError("num_classes required when passing a params tree")
    if variant is None:
        variant = decoder_variant(params["decoder"])

    tf_model = build_tf_reference_model(num_classes, width_mult=width_mult,
                                        fc_channels=fc_channels, variant=variant)
    copy_params_to_tf(params, tf_model)

    class Served(tf.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        @tf.function(input_signature=[tf.TensorSpec([None, None, None, 3], tf.uint8,
                                                    name="image")])
        def serve(self, image):
            logits = self.model(tf.cast(image, tf.float32), training=False)
            return {"logits": logits,
                    "argmax": tf.argmax(logits, axis=-1, output_type=tf.int32)}

    served = Served(tf_model)
    tf.saved_model.save(served, out_dir, signatures={"serving_default": served.serve})
    return out_dir


def _jax_kernel_shape(layer: dict) -> tuple:
    """A port layer's kernel shape in the JAX layout (OIHW weight -> HWIO)."""
    if "kernel" in layer:
        return tuple(layer["kernel"].shape)
    o, i, kh, kw = layer["weight"].shape
    return (kh, kw, i, o)


def load_tf_savedmodel_params(savedmodel_dir: str, example_params: dict, *,
                              device="cuda") -> dict:
    """SavedModel (from ``export_tf_savedmodel``) -> the port's fp32 param
    tree shaped like ``example_params`` (a port tree), on ``device``.
    Variables are matched by the layer-scoped names the Keras build assigns
    (``<layer>/kernel|bias``); deconv kernels get the inverse flip/transpose
    (an involution). Without a card the default ``cuda`` raises and names
    ``device="cpu"``."""
    import tensorflow as tf

    from .. import bridge
    from ..kernels import resolve_device

    device = resolve_device(device)
    loaded = tf.saved_model.load(savedmodel_dir)
    # the serving signature captures every layer variable, names intact
    by_name = {v.name.rsplit(":", 1)[0]: v.numpy()
               for v in loaded.signatures["serving_default"].variables}
    out = {part: {} for part in example_params}
    for part, layers in example_params.items():
        for layer, like in layers.items():
            kernel = by_name[f"{layer}/kernel"]
            bias = by_name[f"{layer}/bias"]
            if layer.endswith("deconv"):
                kernel = kernel[::-1, ::-1].transpose(0, 1, 3, 2)
            want = _jax_kernel_shape(like)
            if tuple(kernel.shape) != want:
                raise ValueError(f"{layer}: SavedModel kernel {kernel.shape} != expected {want}")
            out[part][layer] = {"kernel": kernel.astype(np.float32),
                                "bias": bias.astype(np.float32)}
    return bridge.to_port(out, device=device)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3 or argv[0] != "export":
        print(__doc__)
        return 1
    out = export_tf_savedmodel(argv[1], argv[2])
    print(f"exported TF SavedModel to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
