# Developer targets (mirror of the reference's Makefile surface:
# all/test/ci/bench — Makefile:63-116).

PY ?= python
CC ?= cc
PY_ABS := $(shell $(PY) -c "import sys; print(sys.executable)")

.PHONY: all test ci bench bench-all native client client-torch clean

all: native client

native:
	$(PY) -c "from krep_tpu.native import runtime; print('native runtime ok:', runtime._lib)"

# thin native client for the resident engine (daemon.py): restores the
# reference C binary's ~ms startup. Bakes this repo root (PYTHONPATH for
# spawned/fallback python) and the build python.
client: bin/krep-tpu

bin/krep-tpu: krep_tpu/native/client.c
	mkdir -p bin
	$(CC) -O2 -Wall -DKREP_TPU_ROOT='"$(CURDIR)"' \
	  -DKREP_TPU_PYTHON_DEFAULT='"$(PY_ABS)"' -o $@ $<

# the PyTorch port's client (krep_tpu_torch/native/client.c), built into
# build/krep_tpu_torch/ by the port itself; prints the binary's path
client-torch:
	$(PY) -m krep_tpu_torch.native.client

test:
	$(PY) -m pytest tests/ -x -q

ci: native test

bench:
	$(PY) bench.py

bench-all:
	$(PY) bench.py --all

clean:
	rm -rf corpus .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
