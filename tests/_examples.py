"""Import the scripts of ``examples/`` as modules, by path: their
``if __name__ == "__main__"`` blocks do not run. A twin
(``examples/torch_<name>.py``) loads under its own name, a reference
example under ``ref_<name>`` so that the two never share a module."""
import importlib.util
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_twin(name: str):
    """``examples/<name>.py``, a twin of the port (``torch_<example>``)."""
    return _load(name, name)


def load_reference(name: str):
    """``examples/<name>.py``, a reference example, as ``ref_<name>``."""
    return _load(name, f"ref_{name}")
