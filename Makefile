.PHONY: test native bench bench-all smoke clean viewer

native:
	$(MAKE) -C raytracer_tpu/native

test: native
	python -m pytest tests/ -q

# end-to-end check of the main path on one GPU
smoke: native
	python chip_smoke.py

bench:
	python bench.py

bench-all:
	BENCH_CONFIG=all python bench.py

viewer:
	python -m raytracer_tpu.app.viewer --config demo

clean:
	$(MAKE) -C raytracer_tpu/native clean
	find . -name __pycache__ -type d -exec rm -rf {} +
