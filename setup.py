from setuptools import find_packages, setup

setup(
    name="colate_tpu",
    version="0.1.0",
    description="JAX coalescence-rate engine (Colate-compatible)",
    packages=find_packages(exclude=("tests",)),
    python_requires=">=3.10",
    entry_points={"console_scripts": ["colate-tpu=colate_tpu.cli:main"]},
)
