# Developer conveniences (the reference wraps catkin/cmake; here: pytest,
# bench, and the native library build).

.PHONY: all test test-device bench bench-quick native clean

all: native

native:
	python -c "from nautilus_tpu.ingest.native import get_lib; \
	           print('native bag reader:', 'ok' if get_lib() else 'unavailable')"

# Suite runs split across 4 worker processes (pytest-xdist, one file per
# worker at a time): a full single-process run accumulates hundreds of
# compiled XLA:CPU programs and has tripped a native-codegen segfault
# inside LLVM; per-worker state stays far below that, and the wall clock
# drops ~2x as a bonus.
test:
	python -m pytest tests/ -q -n 4 --dist loadfile

# On-device parity lane (tests/test_device_parity.py): needs a GPU.
test-device:
	NAUTILUS_DEVICE_TESTS=1 python -m pytest tests -m device -q

bench:
	python bench.py

bench-quick:
	python bench.py --quick

clean:
	rm -f nautilus_tpu/native/*.so
	find . -name __pycache__ -type d -exec rm -rf {} +
