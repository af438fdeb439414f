// Fast Wavefront OBJ triangle parser (native host component).
//
// Equivalent of the reference's fscanf-based loader
// (CLOBJloader::LoadTriangles, CLOBJloader.cpp:16-129), written fresh:
// single-pass buffered parse, fan triangulation, v/vt/vn index forms
// (including negative indices), flat SoA float output ready to wrap as
// jnp buffers. Materials stay in Python (MTL files are tiny); this
// handles the hot part — multi-hundred-k-triangle geometry.
//
// Two-call protocol for ctypes: obj_count() sizes the output, then
// obj_parse() fills caller-allocated buffers.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ParseState {
  std::vector<float> pos, nrm, uv;          // flat xyz / xyz / uv records
  std::vector<int> f_pos, f_uv, f_nrm;      // per-corner indices (-1 = none)
  std::vector<int> f_mat;                   // per-triangle material slot
  std::vector<std::string> mat_names;       // usemtl order of appearance
};

int resolve(long idx, size_t count) {
  if (idx > 0) return int(idx - 1);
  if (idx < 0) return int(long(count) + idx);
  return -1;
}

bool parse_file(const char* path, ParseState* st) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char line[4096];
  int cur_mat = -1;  // -1 = no usemtl seen yet (caller maps to default)
  std::vector<int> cp, ct, cn;  // corners of the current face
  while (std::fgets(line, sizeof(line), f)) {
    char* p = line;
    while (*p == ' ' || *p == '\t') ++p;
    if (p[0] == 'v' && p[1] == ' ') {
      float x = 0, y = 0, z = 0;
      std::sscanf(p + 2, "%f %f %f", &x, &y, &z);
      st->pos.insert(st->pos.end(), {x, y, z});
    } else if (p[0] == 'v' && p[1] == 'n' && p[2] == ' ') {
      float x = 0, y = 0, z = 0;
      std::sscanf(p + 3, "%f %f %f", &x, &y, &z);
      st->nrm.insert(st->nrm.end(), {x, y, z});
    } else if (p[0] == 'v' && p[1] == 't' && p[2] == ' ') {
      float x = 0, y = 0;
      std::sscanf(p + 3, "%f %f", &x, &y);
      st->uv.insert(st->uv.end(), {x, y});
    } else if (std::strncmp(p, "usemtl", 6) == 0) {
      char name[512] = {0};
      std::sscanf(p + 6, "%511s", name);
      cur_mat = -1;
      for (size_t i = 0; i < st->mat_names.size(); ++i)
        if (st->mat_names[i] == name) { cur_mat = int(i); break; }
      if (cur_mat < 0) {
        st->mat_names.emplace_back(name);
        cur_mat = int(st->mat_names.size()) - 1;
      }
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      cp.clear(); ct.clear(); cn.clear();
      char* tok = p + 2;
      while (*tok) {
        while (*tok == ' ' || *tok == '\t') ++tok;
        if (!*tok || *tok == '\n' || *tok == '\r') break;
        long vi = std::strtol(tok, &tok, 10);
        long ti = 0, ni = 0;
        if (*tok == '/') {
          ++tok;
          if (*tok != '/') ti = std::strtol(tok, &tok, 10);
          if (*tok == '/') {
            ++tok;
            ni = std::strtol(tok, &tok, 10);
          }
        }
        cp.push_back(resolve(vi, st->pos.size() / 3));
        ct.push_back(resolve(ti, st->uv.size() / 2));
        cn.push_back(resolve(ni, st->nrm.size() / 3));
      }
      // Fan triangulation (reference: CLOBJloader.cpp:101-126).
      for (size_t i = 1; i + 1 < cp.size(); ++i) {
        int corners[3] = {0, int(i), int(i + 1)};
        for (int c : corners) {
          st->f_pos.push_back(cp[c]);
          st->f_uv.push_back(ct[c]);
          st->f_nrm.push_back(cn[c]);
        }
        st->f_mat.push_back(cur_mat);
      }
    }
  }
  std::fclose(f);
  return true;
}

ParseState* g_state = nullptr;

}  // namespace

extern "C" {

// Parse the file and return the triangle count (negative on error).
// Caches the parse for the matching obj_fill() call.
int64_t obj_count(const char* path) {
  delete g_state;
  g_state = new ParseState();
  if (!parse_file(path, g_state)) {
    delete g_state;
    g_state = nullptr;
    return -1;
  }
  return int64_t(g_state->f_mat.size());
}

// Number of distinct usemtl names seen (call after obj_count).
int obj_num_materials() {
  return g_state ? int(g_state->mat_names.size()) : 0;
}

// Copy material name i (NUL-terminated) into buf.
int obj_material_name(int i, char* buf, int cap) {
  if (!g_state || i < 0 || i >= int(g_state->mat_names.size())) return -1;
  std::snprintf(buf, cap, "%s", g_state->mat_names[i].c_str());
  return 0;
}

// Fill caller buffers: v/n/uv are [3, T, 3|2] corner-major SoA flattened
// as v0 block then v1 then v2; mat is [T]. Missing normals are filled
// with the face normal, missing uvs with zero. Returns 0, or -1 if no
// parse is cached.
int obj_fill(float* v, float* n, float* uvbuf, int32_t* mat) {
  if (!g_state) return -1;
  ParseState& st = *g_state;
  int64_t T = int64_t(st.f_mat.size());
  for (int64_t t = 0; t < T; ++t) {
    float fp[3][3];
    float fn[3][3] = {{0}};
    bool have_n = true;
    for (int c = 0; c < 3; ++c) {
      int pi = st.f_pos[3 * t + c];
      for (int k = 0; k < 3; ++k) fp[c][k] = st.pos[3 * pi + k];
      int ni = st.f_nrm[3 * t + c];
      if (ni >= 0 && ni < int(st.nrm.size() / 3)) {
        for (int k = 0; k < 3; ++k) fn[c][k] = st.nrm[3 * ni + k];
      } else {
        have_n = false;
      }
    }
    if (!have_n) {
      float e1[3], e2[3], gn[3];
      for (int k = 0; k < 3; ++k) {
        e1[k] = fp[1][k] - fp[0][k];
        e2[k] = fp[2][k] - fp[0][k];
      }
      gn[0] = e1[1] * e2[2] - e1[2] * e2[1];
      gn[1] = e1[2] * e2[0] - e1[0] * e2[2];
      gn[2] = e1[0] * e2[1] - e1[1] * e2[0];
      float len = std::sqrt(gn[0] * gn[0] + gn[1] * gn[1] + gn[2] * gn[2]);
      if (len <= 0) { gn[0] = gn[1] = 0; gn[2] = 1; len = 1; }
      for (int c = 0; c < 3; ++c)
        for (int k = 0; k < 3; ++k) fn[c][k] = gn[k] / len;
    }
    for (int c = 0; c < 3; ++c) {
      for (int k = 0; k < 3; ++k) {
        v[(int64_t(c) * T + t) * 3 + k] = fp[c][k];
        n[(int64_t(c) * T + t) * 3 + k] = fn[c][k];
      }
      int ti = st.f_uv[3 * t + c];
      for (int k = 0; k < 2; ++k)
        uvbuf[(int64_t(c) * T + t) * 2 + k] =
            (ti >= 0 && ti < int(st.uv.size() / 2)) ? st.uv[2 * ti + k] : 0.f;
    }
    // -1 (face before any usemtl) is passed through; the Python side
    // remaps slots to MTL-declaration order and sends -1 to material 0.
    mat[t] = st.f_mat[t];
  }
  delete g_state;
  g_state = nullptr;
  return 0;
}

}  // extern "C"
