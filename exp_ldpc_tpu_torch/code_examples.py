"""Standard test-code fixtures (reference: ``python/qldpc/code_examples.py``)."""
from .codes.hgp import random_test_hgp

__all__ = ["random_test_hgp"]
