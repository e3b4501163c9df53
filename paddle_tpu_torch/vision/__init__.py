"""paddle.vision: the models (``vision.models``), the detection ops
(``vision.ops``), the datasets (``vision.datasets``), the transforms
(``vision.transforms``) and the image backend switch."""
from . import datasets, models, ops, transforms

__all__ = ["datasets", "models", "ops", "transforms", "set_image_backend",
           "get_image_backend", "image_load"]

_image_backend = "pil"


def set_image_backend(backend):
    """Only 'pil' is available (cv2 is not shipped), as in the reference:
    anything else raises."""
    global _image_backend
    if backend != "pil":
        raise ValueError(
            f"unsupported image backend {backend!r}: only 'pil' is "
            f"available (cv2 is not shipped)")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """Open an image file with PIL on the host (the input pipeline's
    decode)."""
    from PIL import Image
    return Image.open(path)
