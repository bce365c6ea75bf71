# NGSpeciesID in JAX — self-contained image (no external bioinformatics
# binaries; all compute engines are in-package).  For GPU hosts start from a
# CUDA image with nvcc and install the jax[cuda12] wheel instead of the CPU
# default.
FROM python:3.12-slim
RUN apt-get update && apt-get install -y --no-install-recommends g++ && rm -rf /var/lib/apt/lists/*
WORKDIR /app
COPY . .
RUN pip install --no-cache-dir -e .
ENTRYPOINT ["NGSpeciesID-jax"]
