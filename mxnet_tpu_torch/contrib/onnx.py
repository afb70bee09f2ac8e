"""`contrib.onnx` (counterpart of `mxnet_tpu/contrib/onnx`): ONNX export
and import are not in the port yet. The module exists so that code
importing it loads; its entry points raise `NotPortedError`, naming
ROADMAP.md queue 1's "The facades"."""
from ..ndarray.ndarray import NotPortedError

__all__ = ["export_model", "import_model"]


def _not_ported(name):
    raise NotPortedError(
        f"contrib.onnx.{name} (ONNX export and import) is not in the port "
        "yet (ROADMAP.md queue 1, \"The facades\")")


def export_model(*args, **kwargs):
    _not_ported("export_model")


def import_model(*args, **kwargs):
    _not_ported("import_model")
