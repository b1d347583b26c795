from setuptools import find_packages, setup

setup(
    name='captioning_tpu',
    version='0.1.0',
    description='TPU-native (JAX/XLA/Pallas) image captioning framework',
    packages=find_packages(include=['captioning_tpu', 'captioning_tpu.*',
                                    'captioning_tpu_torch',
                                    'captioning_tpu_torch.*']),
    package_data={'captioning_tpu_torch': ['csrc/*.cu']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'numpy', 'pyyaml', 'h5py', 'Pillow',
    ],
)
