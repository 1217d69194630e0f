"""Kubernetes wire-contract schemas: the third leg of the triangle.

The kubeclient's wire format was previously validated ONLY against
in-repo fake servers — and the fakes only against the client.  A wrong
shared assumption (a misspelled field, a wrong nesting) would pass
both ways.  This module is an
INDEPENDENT authority: JSON Schemas for every body the scheduler
emits and every body it consumes, authored from the upstream
Kubernetes API reference (API docs for core/v1 Binding, Event,
DeleteOptions, Pod, Node; policy/v1 PodDisruptionBudget; the
apimachinery watch framing; and the kube-scheduler extender contract
``k8s.io/kube-scheduler/extender/v1``) — NOT from this repo's client
or fakes.  The conformance tests validate BOTH sides against these
schemas, so a client/fake co-drift now has to also fool a schema
neither of them generated.

Emitted-body schemas are STRICT (``additionalProperties: false``):
everything the scheduler puts on the wire is enumerated, so a typo'd
or hallucinated field fails.  Consumed-body schemas are STRUCTURAL
(extra fields allowed): a real apiserver sends dozens of fields the
scheduler ignores (managedFields, status conditions, ...), and the
schema pins only the shape it actually relies on.

Reference parity notes: Binding POST mirrors scheduler.go:196-206;
Event POST mirrors scheduler.go:214-233 (corev1.Event with
involvedObject/reason/message/source/counts).
"""

from __future__ import annotations

import re
from typing import Any, Mapping


def _jsonschema():
    """Lazy: the schemas themselves are plain dicts and the deploy
    image does not ship jsonschema — importing this module must not
    require it, only VALIDATING does."""
    try:
        import jsonschema
    except ImportError as exc:  # pragma: no cover
        raise RuntimeError(
            "conformance validation requires the 'jsonschema' "
            "package (available in the dev/test environment)") from exc
    return jsonschema

# RFC 1123 DNS label/subdomain as the apiserver enforces for names
# and namespaces.
_DNS_LABEL = r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$"
_DNS_SUBDOMAIN = r"^[a-z0-9]([-a-z0-9.]*[a-z0-9])?$"

# --- core/v1 Binding (the pods/{name}/binding subresource body) -----

BINDING_SCHEMA: dict = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "required": ["apiVersion", "kind", "metadata", "target"],
    "additionalProperties": False,
    "properties": {
        "apiVersion": {"const": "v1"},
        "kind": {"const": "Binding"},
        "metadata": {
            "type": "object",
            "required": ["name"],
            "additionalProperties": False,
            "properties": {
                "name": {"type": "string",
                         "pattern": _DNS_SUBDOMAIN},
                "namespace": {"type": "string",
                              "pattern": _DNS_LABEL},
                "uid": {"type": "string"},
            },
        },
        "target": {
            "type": "object",
            "required": ["kind", "name"],
            "additionalProperties": False,
            "properties": {
                "apiVersion": {"const": "v1"},
                "kind": {"const": "Node"},
                "name": {"type": "string",
                         "pattern": _DNS_SUBDOMAIN},
            },
        },
    },
}

# --- core/v1 Event (namespaced POST body) ---------------------------

EVENT_SCHEMA: dict = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "required": ["apiVersion", "kind", "metadata", "involvedObject",
                 "reason", "message", "type"],
    "additionalProperties": False,
    "properties": {
        "apiVersion": {"const": "v1"},
        "kind": {"const": "Event"},
        "metadata": {
            "type": "object",
            # The apiserver requires name OR generateName.
            "anyOf": [{"required": ["name"]},
                      {"required": ["generateName"]}],
            "additionalProperties": False,
            "properties": {
                "name": {"type": "string"},
                "generateName": {"type": "string"},
                "namespace": {"type": "string",
                              "pattern": _DNS_LABEL},
                # String-valued annotations (the structured link
                # identity of LinkDegraded/LinkQuarantined rides
                # here; a real apiserver accepts any annotations).
                "annotations": {
                    "type": "object",
                    "additionalProperties": {"type": "string"},
                },
            },
        },
        "involvedObject": {
            "type": "object",
            "required": ["kind", "name"],
            "additionalProperties": False,
            "properties": {
                "apiVersion": {"const": "v1"},
                "kind": {"enum": ["Pod", "Node"]},
                "name": {"type": "string"},
                "namespace": {"type": "string"},
                "uid": {"type": "string"},
            },
        },
        "reason": {"type": "string", "minLength": 1,
                   # UpperCamelCase machine-readable short reason, as
                   # kubectl and controllers expect.
                   "pattern": r"^[A-Z][A-Za-z0-9]*$"},
        "message": {"type": "string"},
        "type": {"enum": ["Normal", "Warning"]},
        "count": {"type": "integer", "minimum": 1},
        "firstTimestamp": {"type": "string",
                           "format": "date-time"},
        "lastTimestamp": {"type": "string", "format": "date-time"},
        "source": {
            "type": "object",
            "additionalProperties": False,
            "properties": {
                "component": {"type": "string"},
                "host": {"type": "string"},
            },
        },
    },
}

# --- meta/v1 DeleteOptions (graceful eviction) ----------------------

DELETE_OPTIONS_SCHEMA: dict = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "required": ["apiVersion", "kind"],
    "additionalProperties": False,
    "properties": {
        "apiVersion": {"const": "v1"},
        "kind": {"const": "DeleteOptions"},
        "gracePeriodSeconds": {"type": "integer", "minimum": 0},
        "propagationPolicy": {
            "enum": ["Orphan", "Background", "Foreground"]},
        "preconditions": {"type": "object"},
    },
}

# --- consumed shapes (structural: extra fields allowed) -------------

POD_SCHEMA: dict = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "required": ["metadata"],
    "properties": {
        "apiVersion": {"const": "v1"},
        "kind": {"const": "Pod"},
        "metadata": {
            "type": "object",
            "required": ["name"],
            "properties": {
                "name": {"type": "string"},
                "namespace": {"type": "string"},
                "uid": {"type": "string"},
                "labels": {"type": "object",
                           "additionalProperties": {"type": "string"}},
                "annotations": {
                    "type": "object",
                    "additionalProperties": {"type": "string"}},
                "resourceVersion": {"type": "string"},
            },
        },
        "spec": {
            "type": "object",
            "properties": {
                "nodeName": {"type": "string"},
                "schedulerName": {"type": "string"},
                "priority": {"type": "integer"},
                "nodeSelector": {
                    "type": "object",
                    "additionalProperties": {"type": "string"}},
                "containers": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "properties": {
                            "resources": {
                                "type": "object",
                                "properties": {
                                    "requests": {
                                        "type": "object",
                                        "additionalProperties": {
                                            "type": ["string",
                                                     "number"]}},
                                },
                            },
                        },
                    },
                },
                "tolerations": {"type": "array",
                                "items": {"type": "object"}},
                "affinity": {"type": "object"},
                "topologySpreadConstraints": {
                    "type": "array", "items": {"type": "object"}},
            },
        },
        "status": {
            "type": "object",
            "properties": {
                "phase": {"enum": ["Pending", "Running", "Succeeded",
                                   "Failed", "Unknown"]},
            },
        },
    },
}

NODE_SCHEMA: dict = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "required": ["metadata"],
    "properties": {
        "apiVersion": {"const": "v1"},
        "kind": {"const": "Node"},
        "metadata": {
            "type": "object",
            "required": ["name"],
            "properties": {
                "name": {"type": "string"},
                "labels": {"type": "object",
                           "additionalProperties": {"type": "string"}},
            },
        },
        "spec": {
            "type": "object",
            "properties": {
                "taints": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "required": ["key", "effect"],
                        "properties": {
                            "key": {"type": "string"},
                            "value": {"type": "string"},
                            "effect": {"enum": [
                                "NoSchedule", "PreferNoSchedule",
                                "NoExecute"]},
                        },
                    },
                },
                "unschedulable": {"type": "boolean"},
            },
        },
        "status": {
            "type": "object",
            "properties": {
                "allocatable": {
                    "type": "object",
                    "additionalProperties": {"type": "string"}},
                "capacity": {
                    "type": "object",
                    "additionalProperties": {"type": "string"}},
                "addresses": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "required": ["type", "address"],
                        "properties": {
                            "type": {"type": "string"},
                            "address": {"type": "string"}},
                    },
                },
            },
        },
    },
}

PDB_SCHEMA: dict = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "required": ["metadata"],
    "properties": {
        "apiVersion": {"const": "policy/v1"},
        "kind": {"const": "PodDisruptionBudget"},
        "metadata": {
            "type": "object",
            "required": ["name"],
            "properties": {"name": {"type": "string"},
                           "namespace": {"type": "string"},
                           "uid": {"type": "string"}},
        },
        "spec": {
            "type": "object",
            "properties": {
                "minAvailable": {"type": ["integer", "string"]},
                "maxUnavailable": {"type": ["integer", "string"]},
                "selector": {
                    "type": "object",
                    "properties": {
                        "matchLabels": {
                            "type": "object",
                            "additionalProperties": {
                                "type": "string"}},
                    },
                },
            },
        },
        "status": {
            "type": "object",
            "properties": {
                "disruptionsAllowed": {"type": "integer"},
                "expectedPods": {"type": "integer"},
            },
        },
    },
}

# apimachinery watch framing: one JSON object per chunk/line.
WATCH_EVENT_SCHEMA: dict = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "required": ["type", "object"],
    "properties": {
        "type": {"enum": ["ADDED", "MODIFIED", "DELETED",
                          "BOOKMARK", "ERROR"]},
        "object": {"type": "object"},
    },
}

LIST_SCHEMA: dict = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "required": ["items"],
    "properties": {
        "items": {"type": "array", "items": {"type": "object"}},
        "metadata": {
            "type": "object",
            "properties": {"resourceVersion": {"type": "string"}},
        },
    },
}

# --- kube-scheduler extender contract (extender/v1) -----------------

EXTENDER_ARGS_SCHEMA: dict = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "required": ["pod"],
    "properties": {
        "pod": POD_SCHEMA,
        # Exactly one of nodes / nodenames is set depending on the
        # extender's nodeCacheCapable configuration.
        "nodes": {
            "type": "object",
            "properties": {"items": {"type": "array",
                                     "items": NODE_SCHEMA}},
        },
        "nodenames": {"type": "array", "items": {"type": "string"}},
    },
}

HOST_PRIORITY_LIST_SCHEMA: dict = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "array",
    "items": {
        "type": "object",
        "required": ["host", "score"],
        "additionalProperties": False,
        "properties": {
            "host": {"type": "string"},
            # extender/v1 HostPriority.Score is int64; the stock
            # scheduler expects [0, MaxExtenderPriority=10] unless
            # weighted.
            "score": {"type": "integer"},
        },
    },
}

EXTENDER_FILTER_RESULT_SCHEMA: dict = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "additionalProperties": False,
    "properties": {
        "nodes": {
            "type": ["object", "null"],
            "properties": {"items": {"type": "array",
                                     "items": NODE_SCHEMA}},
        },
        "nodenames": {"type": ["array", "null"],
                      "items": {"type": "string"}},
        "failedNodes": {
            "type": ["object", "null"],
            "additionalProperties": {"type": "string"}},
        "failedAndUnresolvableNodes": {
            "type": ["object", "null"],
            "additionalProperties": {"type": "string"}},
        "error": {"type": ["string", "null"]},
    },
}

# --- request-path dispatch ------------------------------------------

# (method, path-regex) -> schema for the REQUEST body.  None means
# the body must be absent.  Route namespaces reuse the ONE _DNS_LABEL
# grammar (anchors stripped) so body schemas and route patterns can
# never drift apart.
_NS = _DNS_LABEL.strip("^$")
_REQUEST_CONTRACTS: list[tuple[str, str, dict | None]] = [
    ("POST",
     rf"^/api/v1/namespaces/{_NS}/pods/[^/]+/binding$",
     BINDING_SCHEMA),
    ("POST",
     rf"^/api/v1/namespaces/{_NS}/events$",
     EVENT_SCHEMA),
    ("DELETE",
     rf"^/api/v1/namespaces/{_NS}/pods/[^/]+$",
     DELETE_OPTIONS_SCHEMA),
    ("GET", r"^/api/v1/nodes(\?.*)?$", None),
    ("GET", r"^/api/v1/pods(\?.*)?$", None),
    ("GET",
     rf"^/api/v1/namespaces/{_NS}/pods(\?.*)?$",
     None),
    ("GET", r"^/apis/policy/v1/poddisruptionbudgets(\?.*)?$", None),
]


class ConformanceError(AssertionError):
    pass


def validate_request(method: str, path: str,
                     body: Mapping[str, Any] | None) -> None:
    """Validate one client-emitted request (method, path, body)
    against the Kubernetes API contract.  Raises ConformanceError on
    an unknown route or a non-conforming body."""
    for m, pat, schema in _REQUEST_CONTRACTS:
        if m == method and re.match(pat, path):
            if schema is None:
                if body not in (None, {}):
                    raise ConformanceError(
                        f"{method} {path}: unexpected body")
                return
            if body is None:
                # DELETE body (DeleteOptions) is optional.
                if method == "DELETE":
                    return
                raise ConformanceError(
                    f"{method} {path}: body required")
            _validate(body, schema, f"{method} {path}")
            return
    raise ConformanceError(f"no contract for {method} {path}")


_FORMAT_CHECKER = None


def _format_checker():
    """A module-OWNED FormatChecker with a guaranteed date-time rule.
    jsonschema's stock FORMAT_CHECKER silently skips formats whose
    optional validator package (rfc3339-validator) is absent — the
    check would then be inert in exactly the quiet way this module
    exists to prevent — so the RFC 3339 shape is enforced here
    unconditionally."""
    global _FORMAT_CHECKER
    if _FORMAT_CHECKER is None:
        js = _jsonschema()
        fc = js.FormatChecker()

        @fc.checks("date-time")
        def _date_time(value) -> bool:  # noqa: ANN001
            return isinstance(value, str) and bool(re.match(
                r"^\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}"
                r"(\.\d+)?(Z|[+-]\d{2}:\d{2})$", value))

        _FORMAT_CHECKER = fc
    return _FORMAT_CHECKER


def _validate(obj: Any, schema: dict, what: str) -> None:
    js = _jsonschema()
    try:
        # format_checker: without it "format": "date-time" is an
        # inert annotation and a malformed Event timestamp would sail
        # through — the exact co-drift class this module exists for.
        js.validate(obj, schema, format_checker=_format_checker())
    except js.ValidationError as exc:
        raise ConformanceError(
            f"{what}: {exc.message} at "
            f"{list(exc.absolute_path)}") from exc


def validate_pod(obj: Mapping[str, Any]) -> None:
    _validate(obj, POD_SCHEMA, "Pod")


def validate_node(obj: Mapping[str, Any]) -> None:
    _validate(obj, NODE_SCHEMA, "Node")


def validate_pdb(obj: Mapping[str, Any]) -> None:
    _validate(obj, PDB_SCHEMA, "PodDisruptionBudget")


def validate_watch_event(obj: Mapping[str, Any]) -> None:
    """Validate the frame AND the carried object.  The object's kind
    is taken from ``kind`` when present (real apiservers set it on
    watch objects) and sniffed structurally otherwise; an object
    whose kind cannot be determined FAILS — a silent skip here would
    hollow out exactly the drift detection this module exists for."""
    _validate(obj, WATCH_EVENT_SCHEMA, "WatchEvent")
    if obj["type"] in ("ERROR", "BOOKMARK"):
        return
    o = obj["object"]
    kind = o.get("kind", "")
    if not kind:
        spec, status = o.get("spec", {}), o.get("status", {})
        if "containers" in spec or "schedulerName" in spec \
                or "nodeName" in spec:
            kind = "Pod"
        elif "allocatable" in status or "capacity" in status \
                or "taints" in spec or "unschedulable" in spec:
            kind = "Node"
    if kind == "Pod":
        validate_pod(o)
    elif kind == "Node":
        validate_node(o)
    elif kind == "PodDisruptionBudget":
        validate_pdb(o)
    else:
        raise ConformanceError(
            "WatchEvent object kind undeterminable: "
            f"{sorted(o.keys())}")


def validate_list(obj: Mapping[str, Any]) -> None:
    _validate(obj, LIST_SCHEMA, "List")


def validate_extender_args(obj: Mapping[str, Any]) -> None:
    _validate(obj, EXTENDER_ARGS_SCHEMA, "ExtenderArgs")


def validate_host_priority_list(obj: Any) -> None:
    _validate(obj, HOST_PRIORITY_LIST_SCHEMA, "HostPriorityList")


def validate_extender_filter_result(obj: Mapping[str, Any]) -> None:
    _validate(obj, EXTENDER_FILTER_RESULT_SCHEMA,
              "ExtenderFilterResult")
