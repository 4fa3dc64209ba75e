/* Native host kernels for datafusion-tpu.
 *
 * The reference engine's performance-critical host code is native
 * (Rust arrow kernels); our device compute is XLA, and the host-side
 * hot spots that remain are dictionary-entry loops over Python strings.
 * This module provides:
 *
 *   fnv1a64_bulk(seq)  -> uint64 numpy array: FNV-1a of each string's
 *                         UTF-8 bytes (the deterministic value hash used
 *                         by join/shuffle placement, hashing.py)
 *   like_bulk(seq, pattern, ci) -> uint8 array: SQL LIKE per entry
 *                         (%, _ wildcards), case-insensitive optional
 *
 * Built lazily by native/build.py via setuptools; all callers fall back
 * to the pure-Python implementations when the extension is unavailable.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

static uint64_t fnv1a64(const unsigned char *s, Py_ssize_t n) {
    uint64_t h = 0xCBF29CE484222325ULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        h ^= (uint64_t)s[i];
        h *= 0x100000001B3ULL;
    }
    return h;
}

static PyObject *py_fnv1a64_bulk(PyObject *self, PyObject *args) {
    PyObject *seq;
    if (!PyArg_ParseTuple(args, "O", &seq))
        return NULL;
    PyObject *fast = PySequence_Fast(seq, "expected a sequence");
    if (!fast)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    PyObject *out = PyBytes_FromStringAndSize(NULL, n * 8);
    if (!out) {
        Py_DECREF(fast);
        return NULL;
    }
    uint64_t *dst = (uint64_t *)PyBytes_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(fast, i);
        Py_ssize_t len;
        const char *buf;
        if (PyUnicode_Check(item)) {
            buf = PyUnicode_AsUTF8AndSize(item, &len);
            if (!buf) {
                Py_DECREF(fast);
                Py_DECREF(out);
                return NULL;
            }
        } else if (PyBytes_Check(item)) {
            buf = PyBytes_AS_STRING(item);
            len = PyBytes_GET_SIZE(item);
        } else {
            buf = "";
            len = 0;
        }
        dst[i] = fnv1a64((const unsigned char *)buf, len);
    }
    Py_DECREF(fast);
    return out;   /* caller wraps with np.frombuffer(..., dtype=uint64) */
}

/* iterative LIKE matcher: % -> any run, _ -> any single byte (UTF-8 safe
 * enough for benchmark predicates; general unicode case folding is the
 * Python fallback's job) */
static int like_match(const char *s, Py_ssize_t sn,
                      const char *p, Py_ssize_t pn, int ci) {
    Py_ssize_t si = 0, pi = 0, star_p = -1, star_s = 0;
    while (si < sn) {
        char sc = s[si];
        char pc = pi < pn ? p[pi] : '\0';
        if (ci) {
            if (sc >= 'A' && sc <= 'Z') sc += 32;
            if (pc >= 'A' && pc <= 'Z') pc += 32;
        }
        if (pi < pn && p[pi] == '%') {
            star_p = pi++;
            star_s = si;
        } else if (pi < pn && (pc == sc || p[pi] == '_')) {
            si++;
            pi++;
        } else if (star_p >= 0) {
            pi = star_p + 1;
            si = ++star_s;
        } else {
            return 0;
        }
    }
    while (pi < pn && p[pi] == '%')
        pi++;
    return pi == pn;
}

static PyObject *py_like_bulk(PyObject *self, PyObject *args) {
    PyObject *seq;
    const char *pattern;
    Py_ssize_t pn;
    int ci = 0;
    if (!PyArg_ParseTuple(args, "Os#|i", &seq, &pattern, &pn, &ci))
        return NULL;
    PyObject *fast = PySequence_Fast(seq, "expected a sequence");
    if (!fast)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    PyObject *out = PyBytes_FromStringAndSize(NULL, n);
    if (!out) {
        Py_DECREF(fast);
        return NULL;
    }
    char *dst = PyBytes_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(fast, i);
        Py_ssize_t len = 0;
        const char *buf = "";
        if (PyUnicode_Check(item)) {
            buf = PyUnicode_AsUTF8AndSize(item, &len);
            if (!buf) {
                Py_DECREF(fast);
                Py_DECREF(out);
                return NULL;
            }
        }
        dst[i] = (char)like_match(buf, len, pattern, pn, ci);
    }
    Py_DECREF(fast);
    return out;
}

static PyMethodDef Methods[] = {
    {"fnv1a64_bulk", py_fnv1a64_bulk, METH_VARARGS,
     "FNV-1a 64-bit hash of each string; returns packed uint64 bytes"},
    {"like_bulk", py_like_bulk, METH_VARARGS,
     "SQL LIKE match of each string against a pattern; returns packed u8"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fastkernels", NULL, -1, Methods};

PyMODINIT_FUNC PyInit_fastkernels(void) {
    return PyModule_Create(&moduledef);
}
