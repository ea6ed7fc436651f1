"""Inputs for the solver slice."""
