"""Layers and LM assembly, ported from `repro.models` (dense family)."""
