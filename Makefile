# Reproduction harness (the reference drives everything through `make`,
# makefile:6-23; here the targets run the test suite, benchmark, and the
# experiment scripts).

PY ?= python

.PHONY: test smoke bench native demo mnist humanflow sweep text clean

test:
	$(PY) -m pytest tests/ -q -m 'not slow'

smoke:
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

native:
	g++ -O3 -march=native -shared -fPIC \
	  cnn_graph_tpu/native/graph_kernels.cpp \
	  -o cnn_graph_tpu/native/libgraph_kernels.so

demo:
	$(PY) experiments/usage_demo.py

mnist:
	$(PY) experiments/mnist.py

humanflow:
	$(PY) experiments/humanflow.py

sweep:
	$(PY) experiments/gconv_sweep.py

text:
	$(PY) experiments/text20news.py --synthetic

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; \
	rm -f cnn_graph_tpu/native/libgraph_kernels.so
