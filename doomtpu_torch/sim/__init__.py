"""Simulation state: game state, thinker tables, point location."""
