"""Run the port's `cuda`-marked tests on a GPU machine without JAX or flax.

The port's test files import the JAX package at module level to compare
the two on the CPU; the card cases compare a kernel with its plain PyTorch
version only and never call JAX. Here every import of jax, jaxlib, flax or
optax resolves to a mock, so those files collect where flax is not
installed. Run from the root of the repository:

    python3 tests/run_cuda_tests.py -q -m cuda tests/test_torch_kernels.py \\
        tests/test_torch_dof.py tests/test_torch_depth_route.py

The arguments go to pytest unchanged.
"""

import importlib.abc
import importlib.machinery
import os
import sys
from unittest import mock

MOCKED = ("jax", "jaxlib", "flax", "optax")


class _MockImports(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in MOCKED:
            return importlib.machinery.ModuleSpec(name, self, is_package=True)
        return None

    def create_module(self, spec):
        module = mock.MagicMock(name=spec.name)
        module.__path__ = []
        module.__spec__ = spec
        module.__name__ = spec.name
        if spec.name == "jax":  # tests/conftest.py checks the backend
            module.default_backend.return_value = "cpu"
        return module

    def exec_module(self, module):
        pass


if __name__ == "__main__":
    sys.meta_path.insert(0, _MockImports())
    sys.path.insert(0, os.getcwd())
    import pytest

    sys.exit(pytest.main(sys.argv[1:]))
