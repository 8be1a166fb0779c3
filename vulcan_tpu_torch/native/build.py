"""Build the native runtime: python -m vulcan_tpu_torch.native.build"""
from . import build

if __name__ == "__main__":
    print(f"built: {build()}")
