from setuptools import find_packages, setup

setup(
    name="ngspeciesid",
    version="0.1.0",
    description="Amplicon species-ID engine in JAX (clustering + consensus + polishing)",
    packages=find_packages(exclude=("tests", "tests.*")),
    package_data={"ngspeciesid": ["data/*.npz", "native/*.cpp", "native/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    entry_points={
        "console_scripts": [
            "NGSpeciesID-jax=ngspeciesid.cli:main_and_exit",
        ]
    },
)
