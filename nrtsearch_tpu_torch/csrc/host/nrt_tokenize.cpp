// Native tokenization for the indexing hot loop.
//
// The reference's per-document hot loop is Lucene's token/posting build inside
// IndexWriter.addDocuments (SURVEY.md §3.2). Our Python analyzer chain spends
// most of its time in regex matching and per-token object churn; this CPython
// extension implements the default "standard" analyzer path (word tokens,
// lowercased) directly over the UTF-8 bytes and returns {term: [positions]}
// ready for postings accumulation.
//
// ASCII fast path only: any non-ASCII byte returns None and the caller falls
// back to the Python analyzer (full Unicode segmentation parity preserved).
//
// Build: g++ -O3 -shared -fPIC $(python3-config --includes) \
//        native/nrt_tokenize.cpp -o <pkg>/nrt_native.<abi>.so
// (done automatically by nrtsearch_tpu/native_ext.py on first import)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <string>
#include <unordered_map>
#include <vector>

namespace {

// UAX#29 word segmentation, ASCII subset — MUST mirror the Python
// standard_tokenizer (analysis/analyzers.py): letters/digits/underscore
// form words (WB5/8/9/10/13a/b); one mid char joins when flanked by the
// right classes (WB6/7: letter [':. \'] letter; WB11/12: digit [',;.\'']
// digit). Index-time (here) and query-time (Python) MUST agree.
enum WbClass : unsigned char { WB_AL, WB_NUM, WB_EXT, WB_OTHER };

inline WbClass wb_class(unsigned char c) {
  if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z')) return WB_AL;
  if (c >= '0' && c <= '9') return WB_NUM;
  if (c == '_') return WB_EXT;
  return WB_OTHER;
}

inline bool is_word_class(WbClass w) { return w != WB_OTHER; }

inline bool mid_joins(unsigned char c, WbClass prev, WbClass next) {
  const bool sq_or_dot = (c == '\'' || c == '.');
  if (prev == WB_AL && next == WB_AL) return sq_or_dot || c == ':';
  if (prev == WB_NUM && next == WB_NUM)
    return sq_or_dot || c == ',' || c == ';';
  return false;
}

inline char lower(unsigned char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32)
                                : static_cast<char>(c);
}

// scan one token starting at i (data[i] must be a word class). Appends the
// lowered token text to buf; returns the index AFTER the token. has_alnum
// is false only for pure-underscore runs (dropped, as Lucene does).
inline Py_ssize_t scan_token(const char* data, Py_ssize_t len, Py_ssize_t i,
                             std::string& buf, bool& has_alnum) {
  buf.clear();
  WbClass prev = wb_class(static_cast<unsigned char>(data[i]));
  has_alnum = prev != WB_EXT;
  buf.push_back(lower(static_cast<unsigned char>(data[i])));
  Py_ssize_t j = i + 1;
  while (j < len) {
    unsigned char cj = static_cast<unsigned char>(data[j]);
    WbClass wj = wb_class(cj);
    if (is_word_class(wj)) {
      has_alnum = has_alnum || wj != WB_EXT;
      if (wj != WB_EXT) prev = wj;
      buf.push_back(lower(cj));
      j++;
      continue;
    }
    if (j + 1 < len) {
      WbClass next = wb_class(static_cast<unsigned char>(data[j + 1]));
      if (mid_joins(cj, prev, next)) {
        buf.push_back(static_cast<char>(cj));
        j++;
        continue;
      }
    }
    break;
  }
  return j;
}

// std_term_positions(text: str, position_base: int = 0)
//   -> dict[str, list[int]] | None
PyObject* std_term_positions(PyObject*, PyObject* args) {
  const char* data;
  Py_ssize_t len;
  Py_ssize_t base = 0;
  if (!PyArg_ParseTuple(args, "s#|n", &data, &len, &base)) return nullptr;

  // non-ASCII -> let Python handle full Unicode segmentation
  for (Py_ssize_t i = 0; i < len; i++) {
    if (static_cast<unsigned char>(data[i]) >= 0x80) Py_RETURN_NONE;
  }

  std::unordered_map<std::string, std::vector<long>> terms;
  terms.reserve(64);
  std::string buf;
  long pos = static_cast<long>(base);
  Py_ssize_t i = 0;
  long emitted = 0;
  while (i < len) {
    while (i < len &&
           !is_word_class(wb_class(static_cast<unsigned char>(data[i]))))
      i++;
    if (i >= len) break;
    bool has_alnum = false;
    i = scan_token(data, len, i, buf, has_alnum);
    if (!has_alnum) continue;
    terms[buf].push_back(pos);
    pos++;
    emitted++;
  }

  PyObject* dict = PyDict_New();
  if (!dict) return nullptr;
  for (auto& kv : terms) {
    PyObject* list = PyList_New(static_cast<Py_ssize_t>(kv.second.size()));
    if (!list) {
      Py_DECREF(dict);
      return nullptr;
    }
    for (size_t j = 0; j < kv.second.size(); j++) {
      PyList_SET_ITEM(list, static_cast<Py_ssize_t>(j),
                      PyLong_FromLong(kv.second[j]));
    }
    PyObject* key = PyUnicode_FromStringAndSize(
        kv.first.data(), static_cast<Py_ssize_t>(kv.first.size()));
    if (!key || PyDict_SetItem(dict, key, list) < 0) {
      Py_XDECREF(key);
      Py_DECREF(list);
      Py_DECREF(dict);
      return nullptr;
    }
    Py_DECREF(key);
    Py_DECREF(list);
  }
  // (terms dict, token count) — the count is the field length for norms
  PyObject* count = PyLong_FromLong(emitted);
  PyObject* result = PyTuple_Pack(2, dict, count);
  Py_DECREF(dict);
  Py_DECREF(count);
  return result;
}

// ---------------------------------------------------------------------------
// PostingsAccumulator: batch postings build without per-token PyObjects.
//
// The round-1 flow returned a {term: [positions]} dict per document and
// accumulated postings in Python dict-of-lists, then converted ~1 numpy
// array per (term, doc) entry at flush — the profile showed those two Python
// stages cost ~4x the tokenization itself. This type accumulates postings
// term-major in C++ as documents stream in and emits the packed arrays the
// segment needs in one shot (reference hot loop: Lucene's
// TermsHashPerField/FreqProxTermsWriter inside IndexWriter.addDocuments,
// SURVEY.md §3.2).
//
// Contract (mirrors SegmentBuilder semantics):
//  - docs arrive in ascending doc_id order; per-term entries stay doc-sorted
//  - multiple values / repeated add_* calls for the same doc merge into one
//    (term, doc) entry; an entry's positions stay contiguous because each
//    term vector only ever receives its own tokens, appended at the tail
//  - term ids are assigned in first-seen order (dict-insertion parity)
// ---------------------------------------------------------------------------

struct TermPostings {
  std::vector<int32_t> docs;
  std::vector<int32_t> freqs;
  std::vector<int32_t> positions;      // concat of per-entry position runs
};

struct AccObject {
  PyObject_HEAD
  std::unordered_map<std::string, int32_t>* ids;
  std::vector<std::string>* names;
  std::vector<TermPostings>* terms;
};

inline TermPostings& acc_term(AccObject* self, const std::string& term) {
  auto it = self->ids->find(term);
  if (it == self->ids->end()) {
    int32_t tid = static_cast<int32_t>(self->names->size());
    self->ids->emplace(term, tid);
    self->names->push_back(term);
    self->terms->emplace_back();
    return self->terms->back();
  }
  return (*self->terms)[it->second];
}

inline void acc_token(AccObject* self, const std::string& term, int32_t doc,
                      int32_t pos) {
  TermPostings& tp = acc_term(self, term);
  if (!tp.docs.empty() && tp.docs.back() == doc) {
    tp.freqs.back()++;
  } else {
    tp.docs.push_back(doc);
    tp.freqs.push_back(1);
  }
  tp.positions.push_back(pos);
}

// add_text(doc_id, text, base) -> token count, or -1 for non-ASCII text
// (caller analyzes in Python and calls add_terms instead)
PyObject* acc_add_text(PyObject* self_obj, PyObject* args) {
  AccObject* self = reinterpret_cast<AccObject*>(self_obj);
  int doc_id;
  const char* data;
  Py_ssize_t len;
  Py_ssize_t base = 0;
  if (!PyArg_ParseTuple(args, "is#|n", &doc_id, &data, &len, &base))
    return nullptr;
  for (Py_ssize_t i = 0; i < len; i++) {
    if (static_cast<unsigned char>(data[i]) >= 0x80)
      return PyLong_FromLong(-1);
  }
  std::string buf;
  long pos = static_cast<long>(base);
  Py_ssize_t i = 0;
  long emitted = 0;
  while (i < len) {
    while (i < len &&
           !is_word_class(wb_class(static_cast<unsigned char>(data[i]))))
      i++;
    if (i >= len) break;
    bool has_alnum = false;
    i = scan_token(data, len, i, buf, has_alnum);
    if (!has_alnum) continue;
    acc_token(self, buf, doc_id, static_cast<int32_t>(pos));
    pos++;
    emitted++;
  }
  return PyLong_FromLong(emitted);
}

// add_terms(doc_id, {term: [positions]}) — analyzer-agnostic ingest used by
// the Python fallback (custom analyzers, non-ASCII text)
PyObject* acc_add_terms(PyObject* self_obj, PyObject* args) {
  AccObject* self = reinterpret_cast<AccObject*>(self_obj);
  int doc_id;
  PyObject* dict;
  if (!PyArg_ParseTuple(args, "iO!", &doc_id, &PyDict_Type, &dict))
    return nullptr;
  PyObject *key, *value;
  Py_ssize_t di = 0;
  while (PyDict_Next(dict, &di, &key, &value)) {
    Py_ssize_t klen;
    const char* kdata = PyUnicode_AsUTF8AndSize(key, &klen);
    if (!kdata) return nullptr;
    std::string term(kdata, static_cast<size_t>(klen));
    PyObject* seq = PySequence_Fast(value, "positions must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t j = 0; j < n; j++) {
      long p = PyLong_AsLong(PySequence_Fast_GET_ITEM(seq, j));
      if (p == -1 && PyErr_Occurred()) {
        Py_DECREF(seq);
        return nullptr;
      }
      acc_token(self, term, doc_id, static_cast<int32_t>(p));
    }
    Py_DECREF(seq);
  }
  Py_RETURN_NONE;
}

// finish() -> (terms: list[str], offsets_b: bytes(int64[T]),
//              lengths_b: bytes(int32[T]), doc_ids_b: bytes(int32[P]),
//              freqs_b: bytes(int32[P]), positions_b: bytes(int32[SUMFREQ]))
// pos_offsets = cumsum(freqs) on the Python side.
PyObject* acc_finish(PyObject* self_obj, PyObject*) {
  AccObject* self = reinterpret_cast<AccObject*>(self_obj);
  size_t T = self->names->size();
  size_t P = 0, POS = 0;
  for (auto& tp : *self->terms) {
    P += tp.docs.size();
    POS += tp.positions.size();
  }
  std::vector<int64_t> offsets(T);
  std::vector<int32_t> lengths(T);
  std::vector<int32_t> doc_ids(P);
  std::vector<int32_t> freqs(P);
  std::vector<int32_t> positions(POS);
  size_t pc = 0, xc = 0;
  for (size_t t = 0; t < T; t++) {
    TermPostings& tp = (*self->terms)[t];
    offsets[t] = static_cast<int64_t>(pc);
    lengths[t] = static_cast<int32_t>(tp.docs.size());
    std::copy(tp.docs.begin(), tp.docs.end(), doc_ids.begin() + pc);
    std::copy(tp.freqs.begin(), tp.freqs.end(), freqs.begin() + pc);
    std::copy(tp.positions.begin(), tp.positions.end(),
              positions.begin() + xc);
    pc += tp.docs.size();
    xc += tp.positions.size();
  }
  PyObject* names = PyList_New(static_cast<Py_ssize_t>(T));
  if (!names) return nullptr;
  for (size_t t = 0; t < T; t++) {
    PyObject* s = PyUnicode_FromStringAndSize(
        (*self->names)[t].data(),
        static_cast<Py_ssize_t>((*self->names)[t].size()));
    if (!s) {
      Py_DECREF(names);
      return nullptr;
    }
    PyList_SET_ITEM(names, static_cast<Py_ssize_t>(t), s);
  }
  auto as_bytes = [](const void* p, size_t nbytes) {
    return PyBytes_FromStringAndSize(static_cast<const char*>(p),
                                     static_cast<Py_ssize_t>(nbytes));
  };
  PyObject* result = Py_BuildValue(
      "(NNNNNN)", names,
      as_bytes(offsets.data(), T * sizeof(int64_t)),
      as_bytes(lengths.data(), T * sizeof(int32_t)),
      as_bytes(doc_ids.data(), P * sizeof(int32_t)),
      as_bytes(freqs.data(), P * sizeof(int32_t)),
      as_bytes(positions.data(), POS * sizeof(int32_t)));
  return result;
}

PyObject* acc_new(PyTypeObject* type, PyObject*, PyObject*) {
  AccObject* self = reinterpret_cast<AccObject*>(type->tp_alloc(type, 0));
  if (!self) return nullptr;
  self->ids = new std::unordered_map<std::string, int32_t>();
  self->names = new std::vector<std::string>();
  self->terms = new std::vector<TermPostings>();
  return reinterpret_cast<PyObject*>(self);
}

void acc_dealloc(PyObject* self_obj) {
  AccObject* self = reinterpret_cast<AccObject*>(self_obj);
  delete self->ids;
  delete self->names;
  delete self->terms;
  Py_TYPE(self)->tp_free(self_obj);
}

PyMethodDef acc_methods[] = {
    {"add_text", acc_add_text, METH_VARARGS,
     "tokenize ASCII text (standard analyzer) into the accumulator; -1 if "
     "non-ASCII"},
    {"add_terms", acc_add_terms, METH_VARARGS,
     "ingest a {term: [positions]} map for one document"},
    {"finish", acc_finish, METH_NOARGS,
     "emit packed postings arrays (terms, offsets, lengths, doc_ids, freqs, "
     "positions)"},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject AccType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "nrt_native.PostingsAccumulator",  // tp_name
    sizeof(AccObject),                 // tp_basicsize
};

PyMethodDef methods[] = {
    {"std_term_positions", std_term_positions, METH_VARARGS,
     "standard-analyzer term->positions map for ASCII text, else None"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "nrt_native",
    "native tokenization for nrtsearch_tpu", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_nrt_native(void) {
  AccType.tp_flags = Py_TPFLAGS_DEFAULT;
  AccType.tp_doc = "batch postings accumulator (term-major packed arrays)";
  AccType.tp_new = acc_new;
  AccType.tp_dealloc = acc_dealloc;
  AccType.tp_methods = acc_methods;
  if (PyType_Ready(&AccType) < 0) return nullptr;
  PyObject* mod = PyModule_Create(&moduledef);
  if (!mod) return nullptr;
  Py_INCREF(&AccType);
  if (PyModule_AddObject(mod, "PostingsAccumulator",
                         reinterpret_cast<PyObject*>(&AccType)) < 0) {
    Py_DECREF(&AccType);
    Py_DECREF(mod);
    return nullptr;
  }
  return mod;
}
