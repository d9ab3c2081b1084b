"""Architecture configs — one module per assigned arch + registry.

A plain-Python copy of ``src/repro/configs`` (the apps size their nets
from it: ``get_config(name).reduced()``).
"""
from .base import ModelConfig, ShapeConfig, SHAPES, TrainConfig, shapes_for
from .registry import ASSIGNED, REGISTRY, get_config

__all__ = ['ModelConfig', 'ShapeConfig', 'SHAPES', 'TrainConfig',
           'shapes_for', 'ASSIGNED', 'REGISTRY', 'get_config']
