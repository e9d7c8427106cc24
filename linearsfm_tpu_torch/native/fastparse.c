/* Fast local-map text parser (CPython extension).
 *
 * The reference C++ solver ingests local maps with a per-token fscanf loop
 * (lmj_readInformationStereo, LinearSFMImp.cpp:3044-3131); with thousands
 * of files, parsing is a real startup cost. This module tokenizes the whole
 * file with one strtod/strtoll sweep over a single read and fills numpy
 * arrays directly, the same formats (stereo and mono headers) as the
 * pure-Python tokenizer in io/localmap.py.
 *
 * Exposed as parse(path, is_mono) ->
 *   (header_i64, stno_i64, stval_f64, dims_i64, U, Ui, Uj, W, photo, feature,
 *    V, FBlock)
 * A negative count or a token that is not a number (a truncated or
 * malformed file) raises ValueError.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
  const char *p;
  int bad; /* set when a token does not parse */
} Tok;

static double next_d(Tok *t) {
  char *e;
  double v = strtod(t->p, &e);
  if (e == t->p) t->bad = 1;
  t->p = e;
  return v;
}

static long long next_i(Tok *t) {
  char *e;
  long long v = strtoll(t->p, &e, 10);
  if (e == t->p) t->bad = 1;
  t->p = e;
  return v;
}

static PyObject *np_f64(npy_intp n) {
  return PyArray_SimpleNew(1, &n, NPY_FLOAT64);
}
static PyObject *np_i64(npy_intp n) {
  return PyArray_SimpleNew(1, &n, NPY_INT64);
}
#define DATA_F(o) ((double *)PyArray_DATA((PyArrayObject *)(o)))
#define DATA_I(o) ((long long *)PyArray_DATA((PyArrayObject *)(o)))
#define N_OUT 12

static PyObject *fail(PyObject **objs, char *buf, const char *path) {
  for (int i = 0; i < N_OUT; ++i) Py_XDECREF(objs[i]);
  free(buf);
  if (!PyErr_Occurred())
    PyErr_Format(PyExc_ValueError, "malformed local map %s", path);
  return NULL;
}

static PyObject *parse(PyObject *self, PyObject *args) {
  const char *path;
  int is_mono;
  if (!PyArg_ParseTuple(args, "sp", &path, &is_mono)) return NULL;

  FILE *fh = fopen(path, "rb");
  if (!fh) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return NULL;
  }
  fseek(fh, 0, SEEK_END);
  long sz = ftell(fh);
  fseek(fh, 0, SEEK_SET);
  char *buf = sz >= 0 ? (char *)malloc(sz + 1) : NULL;
  if (!buf) {
    fclose(fh);
    return PyErr_NoMemory();
  }
  if (fread(buf, 1, sz, fh) != (size_t)sz) {
    fclose(fh);
    free(buf);
    PyErr_SetString(PyExc_IOError, "short read");
    return NULL;
  }
  fclose(fh);
  buf[sz] = 0;

  /* hdr stno stval dims U Ui Uj W photo feature V FBlock */
  PyObject *o[N_OUT] = {NULL};
  Tok t = {buf, 0};
  long long header[4] = {0, -1, -1, 1};
  header[0] = next_i(&t); /* Ref */
  if (is_mono) {
    header[1] = next_i(&t); /* ScaP */
    header[2] = next_i(&t); /* Fix */
    header[3] = next_i(&t); /* Sign */
  }
  long long r = next_i(&t);
  if (t.bad || r < 0) return fail(o, buf, path);
  if (!(o[1] = np_i64(r)) || !(o[2] = np_f64(r))) return fail(o, buf, path);
  for (long long i = 0; i < r; ++i) {
    DATA_I(o[1])[i] = next_i(&t);
    DATA_F(o[2])[i] = next_d(&t);
  }
  long long m = next_i(&t), n = next_i(&t);
  long long nU = next_i(&t);
  if (t.bad || m < 0 || n < 0 || nU < 0) return fail(o, buf, path);
  if (!(o[4] = np_f64(36 * nU)) || !(o[5] = np_i64(nU)) ||
      !(o[6] = np_i64(nU)))
    return fail(o, buf, path);
  for (long long i = 0; i < 36 * nU; ++i) DATA_F(o[4])[i] = next_d(&t);
  for (long long i = 0; i < nU; ++i) DATA_I(o[5])[i] = next_i(&t);
  for (long long i = 0; i < nU; ++i) DATA_I(o[6])[i] = next_i(&t);
  long long nW = next_i(&t);
  if (t.bad || nW < 0) return fail(o, buf, path);
  if (!(o[7] = np_f64(18 * nW)) || !(o[8] = np_i64(nW)) ||
      !(o[9] = np_i64(nW)))
    return fail(o, buf, path);
  for (long long i = 0; i < 18 * nW; ++i) DATA_F(o[7])[i] = next_d(&t);
  for (long long i = 0; i < nW; ++i) DATA_I(o[8])[i] = next_i(&t);
  for (long long i = 0; i < nW; ++i) DATA_I(o[9])[i] = next_i(&t);
  if (!(o[10] = np_f64(9 * n)) || !(o[11] = np_i64(n)))
    return fail(o, buf, path);
  for (long long i = 0; i < 9 * n; ++i) DATA_F(o[10])[i] = next_d(&t);
  for (long long i = 0; i < n; ++i) DATA_I(o[11])[i] = next_i(&t);
  if (t.bad) return fail(o, buf, path);
  free(buf);

  if (!(o[0] = np_i64(4)) || !(o[3] = np_i64(2))) return fail(o, NULL, path);
  memcpy(DATA_I(o[0]), header, 4 * sizeof(long long));
  DATA_I(o[3])[0] = m;
  DATA_I(o[3])[1] = n;

  return Py_BuildValue("(NNNNNNNNNNNN)", o[0], o[1], o[2], o[3], o[4], o[5],
                       o[6], o[7], o[8], o[9], o[10], o[11]);
}

static PyMethodDef methods[] = {
    {"parse", parse, METH_VARARGS, "parse(path, is_mono) -> tuple of arrays"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef mod = {PyModuleDef_HEAD_INIT, "fastparse",
                                 "LinearSFM local-map fast parser", -1,
                                 methods};

PyMODINIT_FUNC PyInit_fastparse(void) {
  import_array();
  return PyModule_Create(&mod);
}
