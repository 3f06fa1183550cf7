"""Functional NN layers of the port over nested-dict parameter trees."""
