"""Predicate lowering of the port: include-expressions as torch ops."""
