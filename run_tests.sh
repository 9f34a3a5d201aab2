#!/bin/bash
# Run the CPU test suite (tests/conftest.py gives JAX an 8-device
# virtual CPU mesh; card-only tests, marked gpu, skip there).
exec env JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "not slow" "$@"
