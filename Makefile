# Convenience targets (reference Makefile:1-14 analog).
.PHONY: test bench native baselines sweep clean

test:
	python -m pytest tests/ -q

bench:
	python bench.py

native:
	$(MAKE) -C dpu_olap_tpu/native

baselines:
	bash scripts/run-baselines.sh

sweep:
	bash scripts/run-sweep.sh

clean:
	$(MAKE) -C dpu_olap_tpu/native clean
	rm -rf bench_out baseline_results .jax_cache
