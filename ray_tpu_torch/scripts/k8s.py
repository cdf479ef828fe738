"""Kubernetes deployment generator: the KubeRay operator's surface,
collapsed to manifests (counterpart of ``ray_tpu/scripts/k8s.py``).

Reference analog: the KubeRay RayCluster CRD (head group + worker
groups, rayStartParams) that the reference's docs/tooling target. There
is no custom controller here — a head Deployment + Service and plain
worker Deployments reconcile the same topology with stock Kubernetes
controllers, and the GPU worker group maps to a nodeSelector on GKE's
`cloud.google.com/gke-accelerator` label + `nvidia.com/gpu` resource
requests and limits.

Where it differs from the reference: the containers run
``python -m ray_tpu_torch.scripts.cli``; the accelerator group is the
reference's TPU worker group on the port's hardware, field by field:
``--gpu-workers`` / ``--gpu-accelerator`` / ``--gpus-per-host`` for
``--tpu-workers`` / ``--tpu-accelerator`` / ``--tpu-chips-per-host``, the
Deployment ``<name>-gpu-worker`` (role ``gpu-worker``) for
``<name>-tpu-worker``, ``nvidia.com/gpu`` for ``google.com/tpu``,
``cloud.google.com/gke-accelerator`` for
``cloud.google.com/gke-tpu-accelerator``, and ``GPU=<n>`` in the daemon's
``--resources`` for ``TPU=<n>``. ``manifests_yaml`` writes the YAML itself
(block style, every string double-quoted), because the card's host has
no PyYAML.

`python -m ray_tpu_torch.scripts.cli k8s --workers N [--worker-cpu 8
--worker-memory 16Gi]` prints YAML to stdout; pipe to kubectl apply.
"""

from __future__ import annotations

import json
import re
from typing import Optional

_CLI_MODULE = "ray_tpu_torch.scripts.cli"
_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_./-]*")
# plain scalars YAML 1.1 reads as booleans or null
_YAML_WORDS = {"y", "n", "yes", "no", "on", "off", "true", "false", "null"}


def _container(name: str, image: str, command: list, resources: Optional[dict],
               env: Optional[dict] = None) -> dict:
    c: dict = {"name": name, "image": image, "command": command}
    if resources:
        c["resources"] = {"requests": dict(resources), "limits": dict(resources)}
    if env:
        c["env"] = [{"name": k, "value": str(v)} for k, v in env.items()]
    return c


def generate_manifests(
    name: str = "ray-tpu",
    image: str = "ray-tpu:latest",
    namespace: str = "default",
    gcs_port: int = 6379,
    workers: int = 2,
    worker_resources: str = "num_cpus=4",
    worker_cpu: Optional[str] = None,
    worker_memory: str = "8Gi",
    gpu_workers: int = 0,
    gpu_accelerator: str = "nvidia-h100-80gb",
    gpus_per_host: int = 8,
) -> list:
    """Returns a list of Kubernetes manifest dicts (Service, head
    Deployment, worker Deployment, optional GPU worker Deployment)."""
    labels = {"app": name}
    head_labels = {**labels, "ray-tpu-role": "head"}
    gcs_addr = f"{name}-head.{namespace}.svc:{gcs_port}"
    if worker_cpu is None:
        # pod requests must match what the daemon advertises to the
        # scheduler, or leases over-commit the cgroup. Keep the float
        # form — k8s accepts fractional cpu quantities ("0.5"); int
        # truncation would request cpu:0 for sub-core daemons
        cpus = "4"
        for kv in worker_resources.split(","):
            if kv.startswith("num_cpus="):
                cpus = kv.split("=", 1)[1]
        worker_cpu = cpus

    service = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": f"{name}-head", "namespace": namespace,
                     "labels": labels},
        "spec": {
            "selector": head_labels,
            "ports": [
                {"name": "gcs", "port": gcs_port, "targetPort": gcs_port},
                {"name": "dashboard", "port": 8265, "targetPort": 8265},
            ],
        },
    }

    head = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": f"{name}-head", "namespace": namespace,
                     "labels": head_labels},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": head_labels},
            "template": {
                "metadata": {"labels": head_labels},
                "spec": {
                    "containers": [
                        {
                            **_container(
                                "head", image,
                                ["python", "-m", _CLI_MODULE, "start",
                                 "--head", "--host", "0.0.0.0",
                                 "--port", str(gcs_port),
                                 "--dashboard-port", "8265",
                                 "--persist", "/var/lib/ray-tpu/gcs.snapshot",
                                 "--resources", "num_cpus=2"],
                                {"cpu": "2", "memory": "4Gi"},
                            ),
                            "volumeMounts": [
                                {"name": "gcs-state",
                                 "mountPath": "/var/lib/ray-tpu"}
                            ],
                        }
                    ],
                    # swap for a PVC to survive pod RESCHEDULING; emptyDir
                    # already survives container restarts in place, which
                    # is what --persist protects against on one node
                    "volumes": [{"name": "gcs-state", "emptyDir": {}}],
                },
            },
        },
    }

    worker_labels = {**labels, "ray-tpu-role": "worker"}
    worker = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": f"{name}-worker", "namespace": namespace,
                     "labels": worker_labels},
        "spec": {
            "replicas": workers,
            "selector": {"matchLabels": worker_labels},
            "template": {
                "metadata": {"labels": worker_labels},
                "spec": {
                    "containers": [
                        _container(
                            "worker", image,
                            ["python", "-m", _CLI_MODULE, "start",
                             "--address", gcs_addr,
                             "--host", "0.0.0.0",
                             "--resources", worker_resources],
                            {"cpu": worker_cpu, "memory": worker_memory},
                        )
                    ],
                },
            },
        },
    }

    out = [service, head, worker]
    if gpu_workers > 0:
        gpu_labels = {**labels, "ray-tpu-role": "gpu-worker"}
        # scheduler resources come from --worker-resources (daemon
        # vocabulary), NOT the pod-cpu quantity (k8s vocabulary — may be
        # "3500m", which the daemon's float parse rejects)
        gpu_res = f"{worker_resources},GPU={gpus_per_host}"
        out.append({
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": f"{name}-gpu-worker", "namespace": namespace,
                         "labels": gpu_labels},
            "spec": {
                "replicas": gpu_workers,
                "selector": {"matchLabels": gpu_labels},
                "template": {
                    "metadata": {"labels": gpu_labels},
                    "spec": {
                        "nodeSelector": {
                            "cloud.google.com/gke-accelerator": gpu_accelerator,
                        },
                        "containers": [
                            _container(
                                "gpu-worker", image,
                                ["python", "-m", _CLI_MODULE, "start",
                                 "--address", gcs_addr,
                                 "--host", "0.0.0.0",
                                 "--resources", gpu_res],
                                {"cpu": worker_cpu, "memory": worker_memory,
                                 "nvidia.com/gpu": str(gpus_per_host)},
                            )
                        ],
                    },
                },
            },
        })
    return out


def _yaml_lines(value, indent: int = 0) -> list:
    """Block-style YAML of dicts, lists, ints and strings (strings
    double-quoted in JSON's escapes, which YAML reads the same)."""
    pad = " " * indent
    out = []
    if isinstance(value, dict):
        for k, v in value.items():
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{_yaml_key(k)}:")
                out += _yaml_lines(v, indent + 2)
            else:
                out.append(f"{pad}{_yaml_key(k)}: {_yaml_scalar(v)}")
    elif isinstance(value, list):
        for v in value:
            if isinstance(v, (dict, list)) and v:
                lines = _yaml_lines(v, indent + 2)
                out.append(f"{pad}- {lines[0].lstrip()}")
                out += lines[1:]
            else:
                out.append(f"{pad}- {_yaml_scalar(v)}")
    else:
        out.append(f"{pad}{_yaml_scalar(value)}")
    return out


def _yaml_key(k) -> str:
    """A key as a plain scalar where it reads as the same string."""
    k = str(k)
    plain = _PLAIN_KEY.fullmatch(k) and k.lower() not in _YAML_WORDS
    return k if plain else json.dumps(k)


def _yaml_scalar(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    if isinstance(v, bool) or v is None or isinstance(v, (int, float)):
        return json.dumps(v)
    return json.dumps(str(v))


def manifests_yaml(**kwargs) -> str:
    return "---\n".join(
        "\n".join(_yaml_lines(m)) + "\n" for m in generate_manifests(**kwargs)
    )


def cmd_k8s(args) -> int:
    print(manifests_yaml(
        name=args.name,
        image=args.image,
        namespace=args.namespace,
        gcs_port=args.gcs_port,
        workers=args.workers,
        worker_resources=args.worker_resources,
        worker_cpu=args.worker_cpu,
        worker_memory=args.worker_memory,
        gpu_workers=args.gpu_workers,
        gpu_accelerator=args.gpu_accelerator,
        gpus_per_host=args.gpus_per_host,
    ), end="")
    return 0
