"""Augmentation engine of the port: parameter bundles, presets, the engine."""
