"""Per-architecture configuration modules.

One module per assigned architecture (plus the paper's own BLOOM/OPT models).
Each module registers exactly one ``ModelConfig`` with the exact dimensions
cited from its source paper / model card.
"""
