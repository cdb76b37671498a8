// pyassemble — C-level reassembly of shredded nested columns into python
// row values (dicts / lists / scalars, None for null).
//
// The native parsers (json_parser.cpp, avro_parser.cpp) shred nested
// payloads into typed leaf buffers + presence bytes + list offsets at
// ~4.5M rows/s; what bounded nested decode after that was the PYTHON
// reassembly — per-row dict building in the wrapper ran ~650ns/row even
// through generated dict-literal comprehensions.  This helper walks the
// same buffers with the CPython C API instead (PyDict_New +
// PyDict_SetItem against pre-built interned keys, PyLong/PyFloat straight
// off the typed buffers), the same optional-Python-path pattern as
// interner.cpp's INTERN_HAVE_PYTHON build.
//
// Must be loaded through ctypes.PyDLL (keeps the GIL — every call here
// manipulates Python objects).  The node description is parser-agnostic:
// the wrapper passes whatever jp_col_* / ap_col_* pointers the schema
// tree resolves to, so one assembler serves both formats.
//
// Node types: 0 i64 | 1 f64 | 2 bool | 3 object (PyObject** — the data
// pointer of a materialized numpy object array, e.g. decoded strings) |
// 4 struct (valid = presence, children = fields) | 5 list (offsets =
// per-entry element ranges, single child indexed per ELEMENT — packed
// scalar lists pass the list node's own element buffers as that child).

#include <Python.h>

#include <cstdint>
#include <vector>

namespace {

struct NodeView {
  int type;
  const void* data;
  const uint8_t* valid;
  const uint64_t* offsets;  // lists only
  PyObject* key;            // owned by pa_struct_rows' keys vector
  std::vector<int> kids;
};

// one value of node ni at entry index r (row, or element for nodes under
// a list); returns a NEW reference, nullptr on error
PyObject* build(const std::vector<NodeView>& nodes, int ni, uint64_t r) {
  const NodeView& nd = nodes[ni];
  if (nd.valid && !nd.valid[r]) Py_RETURN_NONE;
  switch (nd.type) {
    case 0:
      return PyLong_FromLongLong(((const int64_t*)nd.data)[r]);
    case 1:
      return PyFloat_FromDouble(((const double*)nd.data)[r]);
    case 2: {
      PyObject* o = ((const uint8_t*)nd.data)[r] ? Py_True : Py_False;
      Py_INCREF(o);
      return o;
    }
    case 3: {
      PyObject* o = ((PyObject* const*)nd.data)[r];
      Py_INCREF(o);
      return o;
    }
    case 4: {
      // presized like CPython's own BUILD_MAP — PyDict_New starts with
      // the shared empty-keys object and pays a resize on first insert
      PyObject* d = _PyDict_NewPresized((Py_ssize_t)nd.kids.size());
      if (!d) return nullptr;
      for (int k : nd.kids) {
        PyObject* v = build(nodes, k, r);
        if (!v || PyDict_SetItem(d, nodes[k].key, v) < 0) {
          Py_XDECREF(v);
          Py_DECREF(d);
          return nullptr;
        }
        Py_DECREF(v);
      }
      return d;
    }
    case 5: {
      uint64_t a = nd.offsets[r], b = nd.offsets[r + 1];
      PyObject* lst = PyList_New((Py_ssize_t)(b - a));
      if (!lst) return nullptr;
      for (uint64_t e = a; e < b; e++) {
        PyObject* v = build(nodes, nd.kids[0], e);
        if (!v) {
          Py_DECREF(lst);
          return nullptr;
        }
        PyList_SET_ITEM(lst, (Py_ssize_t)(e - a), v);  // steals
      }
      return lst;
    }
  }
  Py_RETURN_NONE;
}

}  // namespace

extern "C" {

// Assemble one nested column's python rows.  Parallel node arrays in any
// order with parents[i] -1 for the single root; data[i]/valids[i]/
// offsets[i] as the node type requires (see header comment).  Returns a
// NEW PyList of n row values, or nullptr with a python error set (ctypes
// py_object restype surfaces it).
PyObject* pa_rows(int nnodes, const int* types, const int* parents,
                  const char** names, void* const* data,
                  const uint8_t* const* valids,
                  const uint64_t* const* offsets, uint64_t n) {
  std::vector<NodeView> nodes(nnodes);
  int root = -1;
  bool ok = true;
  for (int i = 0; i < nnodes; i++) {
    NodeView& nd = nodes[i];
    nd.type = types[i];
    nd.data = data[i];
    nd.valid = valids[i];
    nd.offsets = offsets[i];
    nd.key = PyUnicode_FromString(names[i]);
    if (!nd.key) ok = false;
    if (parents[i] < 0)
      root = i;
    else
      nodes[parents[i]].kids.push_back(i);
  }
  PyObject* out = nullptr;
  if (ok && root >= 0) {
    out = PyList_New((Py_ssize_t)n);
    if (out) {
      for (uint64_t r = 0; r < n; r++) {
        PyObject* v = build(nodes, root, r);
        if (!v) {
          Py_DECREF(out);
          out = nullptr;
          break;
        }
        PyList_SET_ITEM(out, (Py_ssize_t)r, v);  // steals
      }
    }
  } else if (ok) {
    PyErr_SetString(PyExc_ValueError, "pa_rows: no root node");
  }
  for (auto& nd : nodes) Py_XDECREF(nd.key);
  return out;
}

}  // extern "C"
