# A copy of otter_tpu/serve/register_worker.py (the port imports nothing of the JAX package);
# tests/test_torch_serve.py holds its output equal to the original's.
"""Manually (re-)register a worker with the controller (reference
`pipeline/serve/register_worker.py` — useful after a controller restart
when the worker's own re-registration loop is disabled).

python -m otter_tpu_torch.serve.register_worker \
    --controller-address http://localhost:21001 \
    --worker-name http://localhost:21002
"""

import argparse

import requests


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--controller-address", required=True)
    p.add_argument("--worker-name", required=True)
    p.add_argument("--check-heart-beat", action="store_true")
    args = p.parse_args()

    status = requests.post(args.worker_name + "/worker_get_status",
                           timeout=10).json()
    r = requests.post(args.controller_address + "/register_worker", json={
        "worker_name": args.worker_name,
        "check_heart_beat": args.check_heart_beat,
        "worker_status": status,
    }, timeout=10)
    r.raise_for_status()
    print(f"registered {args.worker_name} "
          f"(models={status.get('model_names')})")


if __name__ == "__main__":
    main()
