// C-ABI embedding library: host a cake node of the PyTorch/CUDA port
// inside any C/C++/Swift application — the analog of the reference's
// uniffi bindings (cake-ios/src/lib.rs:20-87), which expose
// start_worker() to the iOS app. The exports keep the JAX package's
// names and signatures, so a host built against either library links
// against the other unchanged.
//
// The C layer is marshalling only; all behavior lives in
// cake_tpu_torch/native/embed.py. Works both in a fresh host process
// (Py_InitializeEx) and inside an already-running interpreter
// (PyGILState_Ensure on the existing runtime), so the same .so is usable
// from a C main() and from ctypes-based tests.
//
// Exports (string-returning calls: 0 = success, >0 = buffer too small and
// the value is the capacity needed, <0 = failure — see cake_tpu_last_error):
//   cake_tpu_version(buf, cap)
//   cake_tpu_generate(model_dir, prompt, n, buf, cap)
//   cake_tpu_start_worker(name, model, topo, type, address) -> blocking loop
//   cake_tpu_last_error(buf, cap)

#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>

namespace {

std::mutex g_err_mu;
std::string g_last_error;

void set_error(const std::string &msg) {
  std::lock_guard<std::mutex> lock(g_err_mu);
  g_last_error = msg;
}

void capture_py_error() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  std::string msg = "python error";
  if (value != nullptr) {
    PyObject *s = PyObject_Str(value);
    if (s != nullptr) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  set_error(msg);
}

// Initialise the interpreter if this process doesn't have one yet.
// call_once: concurrent first calls from a multithreaded host must not race
// Py_InitializeEx.
std::once_flag g_py_once;

void ensure_python() {
  std::call_once(g_py_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);  // no signal handlers: the host app owns signals
      // Release the GIL acquired by initialisation so PyGILState_Ensure
      // below works uniformly for embedded and in-process callers.
      PyEval_SaveThread();
    }
  });
}

// 0 = full copy; >0 = truncated, value is the capacity needed (snprintf
// convention); -2 = unusable buffer. Truncation cuts at a UTF-8 boundary.
long copy_out(const std::string &s, char *buf, long cap) {
  if (buf == nullptr || cap <= 0) return -2;
  size_t n = s.size();
  bool truncated = n > static_cast<size_t>(cap) - 1;
  if (truncated) {
    n = static_cast<size_t>(cap) - 1;
    // don't split a multi-byte sequence: back off over continuation bytes
    while (n > 0 && (static_cast<unsigned char>(s[n]) & 0xC0) == 0x80) --n;
  }
  std::memcpy(buf, s.data(), n);
  buf[n] = '\0';
  return truncated ? static_cast<long>(s.size()) + 1 : 0;
}

// Call cake_tpu_torch.native.embed.<fn>(*args); returns the result or nullptr
// (error captured). Caller holds the GIL and owns the returned reference.
PyObject *call_embed(const char *fn, PyObject *args_tuple) {
  PyObject *mod = PyImport_ImportModule("cake_tpu_torch.native.embed");
  if (mod == nullptr) {
    capture_py_error();
    return nullptr;
  }
  PyObject *f = PyObject_GetAttrString(mod, fn);
  Py_DECREF(mod);
  if (f == nullptr) {
    capture_py_error();
    return nullptr;
  }
  PyObject *res = PyObject_CallObject(f, args_tuple);
  Py_DECREF(f);
  if (res == nullptr) capture_py_error();
  return res;
}

}  // namespace

extern "C" {

long cake_tpu_last_error(char *buf, long cap) {
  std::lock_guard<std::mutex> lock(g_err_mu);
  return copy_out(g_last_error, buf, cap);
}

long cake_tpu_version(char *buf, long cap) {
  ensure_python();
  PyGILState_STATE gil = PyGILState_Ensure();
  long rc = -1;
  PyObject *res = call_embed("version", nullptr);
  if (res != nullptr) {
    const char *c = PyUnicode_AsUTF8(res);
    if (c != nullptr) {
      rc = copy_out(c, buf, cap);
    } else {
      capture_py_error();
    }
    Py_DECREF(res);
  }
  PyGILState_Release(gil);
  return rc;
}

long cake_tpu_generate(const char *model_dir, const char *prompt,
                       int sample_len, char *buf, long cap) {
  ensure_python();
  PyGILState_STATE gil = PyGILState_Ensure();
  long rc = -1;
  PyObject *args = Py_BuildValue("(ssi)", model_dir, prompt, sample_len);
  if (args != nullptr) {
    PyObject *res = call_embed("generate", args);
    Py_DECREF(args);
    if (res != nullptr) {
      const char *c = PyUnicode_AsUTF8(res);
      if (c != nullptr) {
        rc = copy_out(c, buf, cap);
      } else {
        capture_py_error();
      }
      Py_DECREF(res);
    }
  } else {
    capture_py_error();
  }
  PyGILState_Release(gil);
  return rc;
}

int cake_tpu_start_worker(const char *name, const char *model_path,
                          const char *topology_path,
                          const char *model_type,
                          const char *address /* nullable */) {
  ensure_python();
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = -1;
  PyObject *args = Py_BuildValue(
      "(sssss)", name ? name : "worker", model_path ? model_path : "",
      topology_path ? topology_path : "",
      model_type ? model_type : "text",
      address ? address : "127.0.0.1:10128");
  if (args != nullptr) {
    PyObject *res = call_embed("start_worker", args);
    Py_DECREF(args);
    if (res != nullptr) {
      if (PyLong_Check(res)) {
        rc = static_cast<int>(PyLong_AsLong(res));
      } else {
        set_error("start_worker returned a non-int");
      }
      Py_DECREF(res);
    }
  } else {
    capture_py_error();
  }
  PyGILState_Release(gil);
  return rc;
}

}  // extern "C"
