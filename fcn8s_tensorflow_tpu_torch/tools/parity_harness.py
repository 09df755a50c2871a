"""Cross-framework numerical parity harness: the TF reference graph against
the port's model. Port of ``tools/parity_harness.py``.

The reference graph (a convolutionalized VGG-16 encoder and the FCN-8s
decoder, rebuilt layer for layer in TF 2.x Keras) gets the same weights as
the port's ``apply_fcn8s``, and logits, argmax, cross-entropy and one Adam
step are compared. If the composed models agree for arbitrary shared
weights, they agree for pretrained ones. TensorFlow runs on the host's CPU;
it is imported inside the functions that need it (``ImportError`` naming
``tensorflow`` where it is not installed, as on the card's machine).

Kernel layout: the port's tree holds convolutions OIHW; ``bridge.to_numpy``
gives the JAX package's layout, HWIO, which Keras takes as it is. TF's
``conv2d_transpose`` is the gradient of a forward conv, so its kernel
(h, w, out, in) is the JAX-layout forward-correlation deconv kernel
spatially flipped with its channel dims swapped:
``K_tf = K_jax[::-1, ::-1].transpose(0, 1, 3, 2)``.

    python -m fcn8s_tensorflow_tpu_torch.tools.parity_harness [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models.vgg16 import VGG16_CONV_LAYERS, VGG_MEAN_RGB


def build_tf_reference_model(num_classes, *, input_shape=(None, None, 3),
                             width_mult=1.0, fc_channels=None,
                             variant="fcn8s"):
    """The reference graph in TF 2.x Keras, layer for layer: 13 conv3x3 +
    ReLU / 5 SAME max-pools, fc6 7x7 conv + ReLU, fc7 1x1 conv + ReLU
    (dropout omitted: parity runs use keep_prob=1), the decoder with
    pool3*1e-4 / pool4*1e-2 scaling, 1x1 score convs, 4/2 + 4/2 + 16/8
    SAME transposed convs with skip adds. fp32 throughout.

    ``variant`` extends the graph to the fcn16s / fcn32s family members
    with the layer names of ``models/fcn8s.py``'s ``_DECODER_SPECS``:
    fcn16s = 4/2 deconv + pool4 skip + 32/16 to full resolution; fcn32s =
    one 64/32 deconv."""
    import tensorflow as tf

    if variant not in ("fcn8s", "fcn16s", "fcn32s"):
        raise ValueError(f"unknown variant {variant!r}")

    def scale(ch):
        return max(8, int(ch * width_mult)) if width_mult != 1.0 else ch

    x = inp = tf.keras.Input(shape=input_shape)
    x = x - tf.constant(VGG_MEAN_RGB, tf.float32)
    taps = {}
    block_ends = {"conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3"}
    for name, _, out_ch in VGG16_CONV_LAYERS:
        x = tf.keras.layers.Conv2D(scale(out_ch), 3, padding="same",
                                   activation="relu", name=name)(x)
        if name in block_ends:
            x = tf.keras.layers.MaxPool2D(2, 2, padding="same")(x)
            taps[name] = x
    fc_ch = fc_channels if fc_channels is not None else scale(4096)
    x = tf.keras.layers.Conv2D(fc_ch, 7, padding="same", activation="relu", name="fc6")(x)
    x = tf.keras.layers.Conv2D(fc_ch, 1, padding="same", activation="relu", name="fc7")(x)

    f7 = tf.keras.layers.Conv2D(num_classes, 1, name="fc7_1x1")(x)
    if variant == "fcn32s":
        out = tf.keras.layers.Conv2DTranspose(num_classes, 64, 32, padding="same",
                                              name="fc7_deconv")(f7)
        return tf.keras.Model(inp, out)
    p4 = tf.keras.layers.Conv2D(num_classes, 1, name="pool4_1x1")(taps["conv4_3"] * 1e-2)
    u1 = tf.keras.layers.Conv2DTranspose(num_classes, 4, 2, padding="same",
                                         name="fc7_deconv")(f7) + p4
    if variant == "fcn16s":
        out = tf.keras.layers.Conv2DTranspose(num_classes, 32, 16, padding="same",
                                              name="fc7_pool4_deconv")(u1)
        return tf.keras.Model(inp, out)
    p3 = tf.keras.layers.Conv2D(num_classes, 1, name="pool3_1x1")(taps["conv3_3"] * 1e-4)
    u2 = tf.keras.layers.Conv2DTranspose(num_classes, 4, 2, padding="same",
                                         name="fc7_pool4_deconv")(u1) + p3
    out = tf.keras.layers.Conv2DTranspose(num_classes, 16, 8, padding="same",
                                          name="fc7_pool4_pool3_deconv")(u2)
    return tf.keras.Model(inp, out)


def copy_params_to_tf(params, tf_model) -> None:
    """Load the port's param tree (any device) into the TF reference graph,
    through the JAX layout and the deconv flip/transpose (module
    docstring)."""
    from .. import bridge

    tree = bridge.to_numpy(params)
    for part in ("encoder", "decoder"):
        for name, layer in tree[part].items():
            kernel = layer["kernel"]
            if name.endswith("deconv"):
                kernel = kernel[::-1, ::-1].transpose(0, 1, 3, 2)
            tf_model.get_layer(name).set_weights([kernel, layer["bias"]])


def tf_forward(tf_model, images) -> np.ndarray:
    """fp32 logits from the TF graph (images raw RGB, any float/uint8)."""
    import tensorflow as tf

    return tf_model(tf.constant(np.asarray(images, np.float32)), training=False).numpy()


def torch_forward(params, images) -> np.ndarray:
    """fp32 logits from the port's ``apply_fcn8s`` (keep_prob 1, fp32
    compute, on the params' device; TF32 off on the card)."""
    import torch

    from .. import bridge
    from ..models.fcn8s import apply_fcn8s

    dev = bridge.param_leaves(params)[0].device
    x = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            logits = apply_fcn8s(bridge.cast_params(params, torch.float32), x,
                                 compute_dtype=torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    return logits.cpu().numpy()


def tf_loss_and_adam_step(tf_model, images, label_ids, num_classes, learning_rate=1e-3):
    """One reference train step: mean softmax-CE over all pixels + Adam with
    TF1 defaults. Returns (loss_before, updated weights dict name ->
    [kernel, bias])."""
    import tensorflow as tf

    opt = tf.keras.optimizers.Adam(learning_rate, beta_1=0.9, beta_2=0.999, epsilon=1e-8)
    one_hot = tf.one_hot(np.asarray(label_ids), num_classes)
    x = tf.constant(np.asarray(images, np.float32))
    with tf.GradientTape() as tape:
        logits = tf_model(x, training=False)
        loss = tf.reduce_mean(
            tf.nn.softmax_cross_entropy_with_logits(labels=one_hot, logits=logits))
    grads = tape.gradient(loss, tf_model.trainable_variables)
    opt.apply_gradients(zip(grads, tf_model.trainable_variables))
    weights = {}
    for layer in tf_model.layers:
        if layer.weights:
            weights[layer.name] = [w.numpy() for w in layer.weights]
    return float(loss), weights


def tf_train_trajectory(tf_model, images, label_ids, num_classes, learning_rate=1e-3, steps=5):
    """Loss sequence over several reference train steps (one persistent
    Adam optimizer, dropout off)."""
    import tensorflow as tf

    opt = tf.keras.optimizers.Adam(learning_rate, beta_1=0.9, beta_2=0.999, epsilon=1e-8)
    one_hot = tf.one_hot(np.asarray(label_ids), num_classes)
    x = tf.constant(np.asarray(images, np.float32))
    losses = []
    for _ in range(steps):
        with tf.GradientTape() as tape:
            logits = tf_model(x, training=False)
            loss = tf.reduce_mean(
                tf.nn.softmax_cross_entropy_with_logits(labels=one_hot, logits=logits))
        grads = tape.gradient(loss, tf_model.trainable_variables)
        opt.apply_gradients(zip(grads, tf_model.trainable_variables))
        losses.append(float(loss))
    return losses


def compare_logits(a, b) -> dict:
    """Parity stats between two (N,H,W,C) fp32 logit arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    diff = np.abs(a - b)
    scale = max(np.abs(a).max(), 1e-12)
    return {
        "max_abs_diff": float(diff.max()),
        "max_rel_diff": float(diff.max() / scale),
        "logit_scale": float(np.abs(a).max()),
        "argmax_agreement": float((np.argmax(a, -1) == np.argmax(b, -1)).mean()),
    }


def main(argv=None) -> dict:
    """Full-width, 20 classes, seed-0 port init; two seeded synthetic
    256x512 scenes (``tools.synthetic.synth_batch``; the JAX script read
    the reference's example photographs, which this repository does not
    hold). Prints ``compare_logits``."""
    import json

    import torch

    from .. import bridge
    from ..examples import add_device_argument, resolve
    from ..models.fcn8s import init_fcn8s
    from .synthetic import synth_batch

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve(args.device)

    num_classes = 20
    params = bridge.to_port(init_fcn8s(torch.Generator().manual_seed(0), num_classes), device=dev)
    tf_model = build_tf_reference_model(num_classes)
    copy_params_to_tf(params, tf_model)
    images = synth_batch(np.random.default_rng(0), 2, 256, 512)[0]
    stats = compare_logits(tf_forward(tf_model, images), torch_forward(params, images))
    print(json.dumps(stats, indent=2))
    return stats


if __name__ == "__main__":
    main()
