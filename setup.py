from setuptools import find_packages, setup

setup(
    name="armour_tpu",
    version="0.1.0",
    description=(
        "TPU-native receding-horizon safe planning and robust control for "
        "serial manipulators (JAX/XLA/Pallas), with a PyTorch/CUDA port "
        "for NVIDIA Hopper (armour_tpu_torch)"
    ),
    packages=find_packages(include=["armour_tpu", "armour_tpu.*",
                                    "armour_tpu_torch", "armour_tpu_torch.*"]),
    package_data={"armour_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "models/*.json"]},
    python_requires=">=3.10",
)
