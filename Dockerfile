# FastSLAM engine image for NVIDIA GPUs.
#
# The reference ships a Dockerfile (reference Dockerfile:1-23) that builds on
# the JdeRobot simulator image and pip-installs the fast_slam_2 package; this
# engine has no simulator dependency — it deploys as a plain Python package
# over a CUDA build of JAX.  Everything is installed at build time; nothing
# is downloaded when the image runs.
#
# Build:  docker build -t fastslam-tpu .
# Smoke:  docker run --rm --gpus 1 fastslam-tpu
#         (records a 512-tick synthetic log and runs 1024-particle
#          production SLAM on it — the same pipeline deploy/launch.sh runs)
# Real:   docker run --rm --gpus 1 -e PARTICLES=100000 -e TICKS=2000 \
#             -e CHUNK=16 fastslam-tpu
# CPU:    docker run --rm -e CPU=1 fastslam-tpu   (kernel in interpret mode)
FROM python:3.12-slim

WORKDIR /app

# g++/make build the native log codec (native/logcodec.cpp) at image build
RUN apt-get update && apt-get install -y --no-install-recommends g++ make \
    && rm -rf /var/lib/apt/lists/*

# JAX with its CUDA 12 plugin (bundles the CUDA runtime libraries)
RUN pip install --no-cache-dir "jax[cuda12]==0.9.0" numpy

COPY pyproject.toml ./
COPY fastslam_tpu ./fastslam_tpu
COPY native ./native
COPY deploy ./deploy
RUN pip install --no-cache-dir . && make -C native -s

# the deploy smoke pipeline: record a synthetic log, run production SLAM,
# print metrics JSON (PARTICLES/TICKS/CHUNK/CPU env-tunable)
ENV SKIP_INSTALL=1
CMD ["bash", "deploy/launch.sh"]
