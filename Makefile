# graphblas_tpu top-level targets (reference: the top Makefile drives
# cmake + the golden-output demo diff; here: native build + tests +
# demos + benchmarks).

PY ?= python
CPU_ENV = JAX_PLATFORMS=cpu XLA_FLAGS="--xla_force_host_platform_device_count=8"

all: native test

native:
	$(MAKE) -C native

test:
	$(PY) -m pytest tests/ -q

# GPU lane: the matmul, Triton and bitpack paths on the card itself
# (every test skips without a GPU)
test-gpu:
	$(PY) -m pytest tests_gpu/ -q -p no:cacheprovider

# smoke run of the main path on one GPU (see chip_smoke.py)
smoke:
	$(PY) chip_smoke.py

coverage:
	$(PY) tools/coverage.py

demos:
	cd $(CURDIR) && for d in simple wildtype complex import bfs tri mis \
	    ktruss dist; do \
	  env $(CPU_ENV) $(PY) demos/$${d}_demo.py || exit 1; \
	done

bench:
	$(PY) bench.py

bench-scaling:
	env $(CPU_ENV) $(PY) bench_scaling.py

clean:
	$(MAKE) -C native clean
	find . -name __pycache__ -type d | xargs rm -rf

.PHONY: all native test test-gpu smoke coverage demos bench bench-scaling \
	clean
