"""Subpackage of mollytpu_torch (mirrors mollytpu.sim)."""
