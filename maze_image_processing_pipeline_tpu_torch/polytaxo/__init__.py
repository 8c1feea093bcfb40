"""Polyhierarchical taxonomy engine.

In-repo implementation of the capability the reference obtains from the
external ``polytaxo`` package (SURVEY.md §2b; exercised at
``predict/pipeline.py:259-444``): a primary taxonomic hierarchy decorated
with tag qualifiers and virtual (alias) taxa, an expression language for
queries/updates, and thresholded decoding of classifier probability vectors
into taxonomic descriptions.

Copy of ``maze_image_processing_pipeline_tpu/polytaxo/__init__.py`` for the PyTorch
port, which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from .core import (
    Description,
    Expression,
    NegatedRealNode,
    PolyTaxonomy,
    PrimaryNode,
    TagNode,
    VirtualNode,
)

__all__ = [
    "PolyTaxonomy",
    "Description",
    "Expression",
    "PrimaryNode",
    "TagNode",
    "VirtualNode",
    "NegatedRealNode",
]
