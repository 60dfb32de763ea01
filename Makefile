# Developer workflow (parity with the reference Makefile's targets,
# reference: Makefile:1-31, adapted to the Python/JAX stack).

PY ?= python
# -march=native is right when the build host IS the run host (the
# auto-build-on-first-use path). Container image builds must override
# with a portable baseline (deploy/Dockerfile passes x86-64-v2) or the
# shipped .so can SIGILL on older CPUs.
NATIVE_ARCH ?= native

.PHONY: test test-fast bench bench-smoke standalone api worker \
        dryrun native clean docker-up docker-down

NATIVE_BASE = native/jpeg_scan.cpp native/jpeg_emit.cpp native/gifquant.cpp \
              native/iputil.cpp

# ipcodec.cpp needs libjpeg's headers; without them the library is built
# from the libjpeg-free sources (entropy scan/emit, GIF quantizer).
native:
	g++ -O3 -march=$(NATIVE_ARCH) -shared -fPIC -pthread \
	  native/ipcodec.cpp $(NATIVE_BASE) -o native/libipcodec.so -ljpeg \
	|| g++ -O3 -march=$(NATIVE_ARCH) -shared -fPIC -pthread \
	  $(NATIVE_BASE) -o native/libipcodec.so

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -x --ignore=tests/test_service_e2e.py --ignore=tests/test_client.py

bench:
	$(PY) bench.py

bench-smoke:
	$(PY) bench.py --smoke

standalone:
	$(PY) -m imageprocessor_tpu.service standalone --port 8034 --data ./data

api:
	$(PY) -m imageprocessor_tpu.service api

worker:
	$(PY) -m imageprocessor_tpu.service worker

dryrun:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	$(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

docker-up:
	docker compose -f deploy/docker-compose.yaml up -d

docker-down:
	docker compose -f deploy/docker-compose.yaml down

clean:
	rm -rf data/ .pytest_cache __pycache__
