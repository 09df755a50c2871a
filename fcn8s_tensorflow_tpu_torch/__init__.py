"""fcn8s_tensorflow_tpu_torch — the PyTorch + CUDA port of ``fcn8s_tensorflow_tpu``
for one NVIDIA H100.

The JAX package beside it is the reference: every module here names its
counterpart there, and ``tests/test_torch_*.py`` run both on the same
weights and inputs. This package imports ``torch``, ``numpy``, PIL and the
standard library, and nothing of the JAX package: ``labels``, ``utils``,
``viz``, ``prep`` and ``evaluation`` hold its own copies of the label
registry, the model summary, the overlay, video and viewer tools, the
ground-truth tools and the offline Cityscapes scorers, and
``native/confusion_matrix.cpp`` is built with g++ at first use. OpenCV is
imported only inside the three ``viz.overlay`` functions whose output is
OpenCV's own (captions, and the two MPEG-4 writers).

Quick start::

    from fcn8s_tensorflow_tpu_torch import FCN8s
    model = FCN8s(num_classes=20, device="cuda")
    ids = model.predict(images)            # (N, H, W) uint8 RGB in, int32 ids out
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, as in the JAX package: `import fcn8s_tensorflow_tpu_torch.ops...`
    # stays cheap
    if name == "FCN8s":
        from .engine.model import FCN8s

        return FCN8s
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
