"""The port's trial-metrics report and span push against the reference's.

``report_tuning_metrics`` (``kubeflow_tpu_torch/examples/common.py``)
writes through the port's ``k8s/client.py:HttpKubeClient`` to a stdlib
HTTP server that keeps ConfigMaps as an API server does; the reference's
writes to its ``FakeKubeClient``. For the inputs of
``tests/test_tuning.py:578`` and ``tests/test_step_telemetry.py:566``
the two ConfigMaps (name, namespace, labels, data) are equal, and so are
the direct reporters' (``tuning/study.py``). Outside a study, on a rank
other than 0, and with a failing client, nothing is written and nothing
raises. ``push_spans``' body, POSTed to a stdlib server, equals the
reference's for the same spans; a refused connection returns False.
"""

import importlib
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from kubeflow_tpu.examples import common as jcommon
from kubeflow_tpu.k8s import FakeKubeClient
from kubeflow_tpu.obs import export as jexport
from kubeflow_tpu.obs import steps as jsteps
from kubeflow_tpu.obs import trace as jtrace
from kubeflow_tpu.utils.metrics import Registry as JRegistry
from kubeflow_tpu_torch.examples import common
from kubeflow_tpu_torch.k8s.client import ApiError, HttpKubeClient
from kubeflow_tpu_torch.obs import export, steps, trace
from kubeflow_tpu_torch.tuning import study
from kubeflow_tpu_torch.utils.metrics import Registry

# the module (``kubeflow_tpu.tuning`` exports a function of that name)
jstudy = importlib.import_module("kubeflow_tpu.tuning.study")

_CM = re.compile(r"^/api/v1/namespaces/([^/]+)/configmaps(?:/([^/]+))?$")


class _ApiServer:
    """ConfigMaps over HTTP: GET (404 if missing), POST (409 if there),
    PUT; every POST body is kept too (for ``push_spans``)."""

    def __init__(self):
        self.objects, self.posts, self.lock = {}, [], threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code, body):
                raw = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                m = _CM.match(self.path)
                with outer.lock:
                    obj = outer.objects.get((m.group(1), m.group(2))) if m \
                        else None
                if obj is None:
                    return self._reply(404, {"reason": "NotFound"})
                self._reply(200, obj)

            def do_POST(self):
                body = self._body()
                m = _CM.match(self.path)
                with outer.lock:
                    outer.posts.append((self.path, body))
                    if m is None:
                        return self._reply(200, {})
                    key = (m.group(1), body["metadata"]["name"])
                    if key in outer.objects:
                        return self._reply(409, {"reason": "AlreadyExists"})
                    body["metadata"]["resourceVersion"] = "1"
                    outer.objects[key] = body
                self._reply(201, body)

            def do_PUT(self):
                body = self._body()
                m = _CM.match(self.path)
                with outer.lock:
                    key = (m.group(1), m.group(2))
                    if key not in outer.objects:
                        return self._reply(404, {"reason": "NotFound"})
                    outer.objects[key] = body
                self._reply(200, body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(5.0)


@pytest.fixture
def api():
    server = _ApiServer()
    yield server
    server.close()


def _cm(obj):
    md = obj["metadata"]
    return (md["name"], md.get("namespace"), md.get("labels"),
            obj.get("data"))


def _same_configmap(api, fake, ns, trial):
    name = study.metrics_configmap_name(trial)
    mine = api.objects[(ns, name)]
    ref = fake.get("v1", "ConfigMap", ns, name)
    assert _cm(mine) == _cm(ref)
    return mine


def test_direct_reporters_write_the_references_configmap(api):
    client = HttpKubeClient(base_url=api.url)
    fake = FakeKubeClient()
    for mod, c in ((study, client), (jstudy, fake)):
        mod.append_trial_history(c, "default", "t1", 1, 0.5)
        mod.append_trial_history(c, "default", "t1", 2, 0.75)
        mod.report_trial_metrics(c, "default", "t1", {"accuracy": 0.9})
    _same_configmap(api, fake, "default", "t1")
    assert study.read_trial_history(client, "default", "t1") == [
        (1, 0.5), (2, 0.75)]
    assert study.read_trial_metrics(client, "default", "t1") == {
        "accuracy": 0.9}
    assert study.read_trial_metrics(client, "default", "none") is None
    assert study.read_trial_history(client, "default", "none") == []


def test_report_tuning_metrics_hook(api, monkeypatch):
    """tests/test_tuning.py:578's inputs through both packages."""
    client = HttpKubeClient(base_url=api.url)
    fake = FakeKubeClient()
    common.report_tuning_metrics(1, {"accuracy": 0.5}, client=client)
    assert api.objects == {}                 # outside a study: a no-op
    monkeypatch.setenv("KFTPU_TRIAL_NAME", "s-t0")
    monkeypatch.setenv("KFTPU_NAMESPACE", "default")
    monkeypatch.setenv("KFTPU_OBJECTIVE_METRIC", "accuracy")
    for hook, c in ((common.report_tuning_metrics, client),
                    (jcommon.report_tuning_metrics, fake)):
        hook(1, {"accuracy": 0.5, "loss": 2.0}, client=c)
        hook(2, {"accuracy": 0.7, "loss": 1.0}, client=c, final=True)
    cm = _same_configmap(api, fake, "default", "s-t0")
    assert json.loads(cm["data"]["__history__"]) == [[1, 0.5], [2, 0.7]]
    assert study.read_trial_metrics(client, "default", "s-t0") == {
        "accuracy": 0.7, "loss": 1.0}


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.5
        return self.t


def _telemetry(mod, registry_cls):
    return mod.StepTelemetry(job="train", namespace="default",
                             clock=_FakeClock(), registry=registry_cls(),
                             use_cost_analysis=False, sync=True)


def test_report_tuning_metrics_uses_telemetry(api, monkeypatch):
    """tests/test_step_telemetry.py:566's inputs through both packages:
    the objective series from the step records, never duplicated by the
    final report, the summary in the harvest; an objective the telemetry
    cannot resolve falls back to the explicit value."""
    client = HttpKubeClient(base_url=api.url)
    fake = FakeKubeClient()
    monkeypatch.setenv("KFTPU_NAMESPACE", "default")
    for hook, c, mod, reg in (
            (common.report_tuning_metrics, client, steps, Registry),
            (jcommon.report_tuning_metrics, fake, jsteps, JRegistry)):
        monkeypatch.setenv("KFTPU_TRIAL_NAME", "s-t0")
        monkeypatch.setenv("KFTPU_OBJECTIVE_METRIC", "loss")
        telem = _telemetry(mod, reg)
        step = telem.wrap(lambda loss: ({}, {"loss": loss}))
        for loss in (2.0, 1.0):
            step(loss)
        hook(2, {"loss": 1.0}, client=c, telemetry=telem)
        hook(2, {"loss": 1.0}, final=True, client=c, telemetry=telem)
        monkeypatch.setenv("KFTPU_TRIAL_NAME", "s-t1")
        monkeypatch.setenv("KFTPU_OBJECTIVE_METRIC", "accuracy")
        hook(1, {"accuracy": 0.9}, client=c, telemetry=telem)
    cm = _same_configmap(api, fake, "default", "s-t0")
    assert json.loads(cm["data"]["__history__"]) == [[1, 2.0], [2, 1.0]]
    harvest = study.read_trial_metrics(client, "default", "s-t0")
    assert harvest["loss"] == 1.0 and "p50_step_s" in harvest
    _same_configmap(api, fake, "default", "s-t1")


def test_history_from_telemetry_is_idempotent_per_step(api):
    client = HttpKubeClient(base_url=api.url)
    fake = FakeKubeClient()
    got = []
    for mod, c, smod, reg in ((study, client, steps, Registry),
                              (jstudy, fake, jsteps, JRegistry)):
        telem = _telemetry(smod, reg)
        step = telem.wrap(lambda loss: ({}, {"loss": loss}))
        for loss in (3.0, 2.0, 1.5):
            step(loss)
        got.append([
            mod.append_history_from_telemetry(c, "default", "study-t0",
                                              telem, "loss"),
            mod.append_history_from_telemetry(c, "default", "study-t0",
                                              telem, "loss"),
            mod.append_history_from_telemetry(c, "default", "study-t1",
                                              telem, "steps_per_sec")])
    assert got[0] == got[1] == [3, 0, 3]
    _same_configmap(api, fake, "default", "study-t0")
    _same_configmap(api, fake, "default", "study-t1")


def test_only_process_zero_reports_and_failures_only_log(api, monkeypatch):
    client = HttpKubeClient(base_url=api.url)
    monkeypatch.setenv("KFTPU_TRIAL_NAME", "s-t9")
    monkeypatch.setenv("KFTPU_OBJECTIVE_METRIC", "accuracy")
    monkeypatch.setenv("KFTPU_PROCESS_ID", "1")
    common.report_tuning_metrics(1, {"accuracy": 0.5}, client=client,
                                 final=True)
    assert api.objects == {}
    monkeypatch.setenv("KFTPU_PROCESS_ID", "0")
    dead = HttpKubeClient(base_url="http://127.0.0.1:9")   # refused
    common.report_tuning_metrics(1, {"accuracy": 0.5}, client=dead,
                                 final=True)
    assert api.objects == {}


def test_http_client_create_conflict_and_errors(api):
    client = HttpKubeClient(base_url=api.url)
    cm = {"apiVersion": "v1", "kind": "ConfigMap",
          "metadata": {"name": "x", "namespace": "ns"}, "data": {"a": "1"}}
    client.create(cm)
    with pytest.raises(ApiError) as err:
        client.create(cm)
    assert err.value.code == 409
    with pytest.raises(ApiError) as err:
        client.get("v1", "ConfigMap", "ns", "missing")
    assert err.value.code == 404
    assert client.get_or_none("v1", "ConfigMap", "ns", "missing") is None
    client.apply(dict(cm, data={"a": "2"}))
    assert client.get("v1", "ConfigMap", "ns", "x")["data"] == {"a": "2"}
    assert client._path("v1", "ConfigMap", "ns", "x") == \
        "/api/v1/namespaces/ns/configmaps/x"


def _spans(span_cls):
    return [span_cls(trace_id="a" * 32, span_id="b" * 16, parent_id=None,
                     name="serving.predict", start=10.5, end=10.75,
                     attrs={"model": "m", "tokens": 3}),
            span_cls(trace_id="a" * 32, span_id="c" * 16,
                     parent_id="b" * 16, name="engine.step", start=10.6,
                     end=None, status="ERROR")]


def test_push_spans_body_equals_the_references(api, monkeypatch):
    url = api.url + "/api/traces:ingest"
    assert export.push_spans(_spans(trace.Span), url=url) is True
    assert jexport.push_spans(_spans(jtrace.Span), url=url) is True
    (p1, mine), (p2, ref) = api.posts
    assert p1 == p2 == "/api/traces:ingest"
    assert mine == ref and len(mine["spans"]) == 2
    assert export.DEFAULT_COLLECTOR_URL == jexport.DEFAULT_COLLECTOR_URL
    assert export.ENV_COLLECTOR_URL == jexport.ENV_COLLECTOR_URL
    monkeypatch.setenv(export.ENV_COLLECTOR_URL, url)
    assert export.push_spans(_spans(trace.Span)) is True
    assert api.posts[-1][1] == ref


def test_push_spans_never_raises(caplog):
    assert export.push_spans(_spans(trace.Span),
                             url="http://127.0.0.1:9/api/traces:ingest",
                             timeout=2.0) is False
    assert any("span push" in r.message for r in caplog.records)
