"""Rendering: camera stage, level tables, paint orchestration."""
