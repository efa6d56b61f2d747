// Columnar CSV loader of ydf_tpu_torch: host C++, not a kernel.
//
// The port's own copy of the JAX package's loader (native/csv_loader.cc),
// built with g++ into ydf_tpu_torch/build/ at first use and called
// through ctypes (dataset/native_csv.py). It parses a CSV once,
// column-wise, producing
//   * numeric columns  -> double arrays (missing = NaN)
//   * string columns   -> int32 dictionary codes + a unique-value table
// exposed through a C ABI.
//
// Quoting: RFC-4180 double quotes, embedded separators and escaped quotes.
// Type inference: a column is numeric iff every non-empty cell parses as a
// float. Empty cells and pandas' default NA markers are missing (NaN /
// code -1).

#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Column {
  std::string name;
  bool is_numeric = true;
  std::vector<double> numeric;          // valid iff is_numeric
  std::vector<int32_t> codes;           // valid iff !is_numeric
  std::vector<std::string> dictionary;  // valid iff !is_numeric
};

struct CsvFile {
  std::vector<Column> columns;
  int64_t num_rows = 0;
  std::string error;
};

// Parses one CSV record (handles quoted fields); returns false at EOF.
bool ReadRecord(const std::string& data, size_t& pos,
                std::vector<std::string>& fields) {
  fields.clear();
  if (pos >= data.size()) return false;
  std::string cur;
  bool in_quotes = false;
  while (pos < data.size()) {
    char c = data[pos];
    if (in_quotes) {
      if (c == '"') {
        if (pos + 1 < data.size() && data[pos + 1] == '"') {
          cur.push_back('"');
          ++pos;
        } else {
          in_quotes = false;
        }
      } else {
        cur.push_back(c);
      }
    } else if (c == '"') {
      in_quotes = true;
    } else if (c == ',') {
      fields.push_back(std::move(cur));
      cur.clear();
    } else if (c == '\r') {
      // swallow (handled with the following \n)
    } else if (c == '\n') {
      ++pos;
      fields.push_back(std::move(cur));
      return true;
    } else {
      cur.push_back(c);
    }
    ++pos;
  }
  fields.push_back(std::move(cur));
  return true;
}

bool ParseDouble(const std::string& s, double* out) {
  // std::from_chars: locale-independent (strtod honours LC_NUMERIC, which
  // would silently flip '.'-decimal columns to categorical under
  // comma-decimal locales).
  const char* b = s.data();
  const char* e = b + s.size();
  while (b < e && std::isspace(static_cast<unsigned char>(*b))) ++b;
  while (e > b && std::isspace(static_cast<unsigned char>(e[-1]))) --e;
  if (b < e && *b == '+') ++b;  // from_chars rejects a leading '+'
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  auto res = std::from_chars(b, e, *out);
  return res.ec == std::errc() && res.ptr == e;
#else
  // libstdc++ < 11 declares only the integer overloads, which made this
  // translation unit fail to COMPILE — i.e. the native loader silently
  // never built on gcc-10 hosts. strtod fallback on a NUL-terminated
  // copy; "C" locale is assumed (process default; matches pandas).
  if (b == e) return false;
  std::string trimmed(b, e);
  char* endp = nullptr;
  *out = std::strtod(trimmed.c_str(), &endp);
  return endp == trimmed.c_str() + trimmed.size();
#endif
}

// The pandas default NA marker set (pandas.read_csv na_values), so the
// native and fallback readers agree on missingness. Note '?' is NOT a
// pandas default (adult's '?' stays a real category).
bool IsMissing(const std::string& s) {
  static const char* kMarkers[] = {
      "",       "#N/A", "#N/A N/A", "#NA",  "-1.#IND", "-1.#QNAN",
      "-NaN",   "-nan", "1.#IND",   "1.#QNAN", "<NA>", "N/A",
      "NA",     "NULL", "NaN",      "None", "n/a",     "nan",
      "null"};
  for (const char* m : kMarkers)
    if (s == m) return true;
  return false;
}

}  // namespace

extern "C" {

void* ydf_csv_load(const char* path) {
  auto* file = new CsvFile();
  std::ifstream in(path, std::ios::binary);
  if (!in) {
    file->error = "cannot open file";
    return file;
  }
  std::string data((std::istreambuf_iterator<char>(in)),
                   std::istreambuf_iterator<char>());

  size_t pos = 0;
  std::vector<std::string> fields;
  if (!ReadRecord(data, pos, fields) || fields.empty()) {
    file->error = "empty file";
    return file;
  }
  const size_t num_cols = fields.size();
  file->columns.resize(num_cols);
  for (size_t i = 0; i < num_cols; ++i) file->columns[i].name = fields[i];

  // Raw cells, column-major, first pass (type inference needs the full
  // column before committing to a representation).
  std::vector<std::vector<std::string>> cells(num_cols);
  while (ReadRecord(data, pos, fields)) {
    if (fields.size() == 1 && fields[0].empty()) continue;  // blank line
    if (fields.size() != num_cols) {
      file->error = "inconsistent number of fields at row " +
                    std::to_string(file->num_rows + 2);
      return file;
    }
    for (size_t i = 0; i < num_cols; ++i)
      cells[i].push_back(std::move(fields[i]));
    ++file->num_rows;
  }

  for (size_t i = 0; i < num_cols; ++i) {
    Column& col = file->columns[i];
    double v;
    bool numeric = true;
    bool any_value = false;
    for (const auto& cell : cells[i]) {
      if (IsMissing(cell)) continue;
      any_value = true;
      if (!ParseDouble(cell, &v)) {
        numeric = false;
        break;
      }
    }
    col.is_numeric = numeric && any_value;
    if (col.is_numeric) {
      col.numeric.reserve(cells[i].size());
      for (const auto& cell : cells[i]) {
        if (IsMissing(cell)) {
          col.numeric.push_back(std::nan(""));
        } else {
          ParseDouble(cell, &v);
          col.numeric.push_back(v);
        }
      }
    } else {
      std::unordered_map<std::string, int32_t> dict;
      col.codes.reserve(cells[i].size());
      for (const auto& cell : cells[i]) {
        if (IsMissing(cell)) {
          // pandas applies its NA markers to object columns too.
          col.codes.push_back(-1);
          continue;
        }
        auto it = dict.find(cell);
        if (it == dict.end()) {
          it = dict.emplace(cell, (int32_t)col.dictionary.size()).first;
          col.dictionary.push_back(cell);
        }
        col.codes.push_back(it->second);
      }
    }
    cells[i].clear();
    cells[i].shrink_to_fit();
  }
  return file;
}

void ydf_csv_free(void* handle) { delete static_cast<CsvFile*>(handle); }

const char* ydf_csv_error(void* handle) {
  return static_cast<CsvFile*>(handle)->error.c_str();
}

int64_t ydf_csv_num_rows(void* handle) {
  return static_cast<CsvFile*>(handle)->num_rows;
}

int32_t ydf_csv_num_cols(void* handle) {
  return (int32_t)static_cast<CsvFile*>(handle)->columns.size();
}

const char* ydf_csv_col_name(void* handle, int32_t i) {
  return static_cast<CsvFile*>(handle)->columns[i].name.c_str();
}

int32_t ydf_csv_col_is_numeric(void* handle, int32_t i) {
  return static_cast<CsvFile*>(handle)->columns[i].is_numeric ? 1 : 0;
}

const double* ydf_csv_col_numeric(void* handle, int32_t i) {
  return static_cast<CsvFile*>(handle)->columns[i].numeric.data();
}

const int32_t* ydf_csv_col_codes(void* handle, int32_t i) {
  return static_cast<CsvFile*>(handle)->columns[i].codes.data();
}

int32_t ydf_csv_col_dict_size(void* handle, int32_t i) {
  return (int32_t)static_cast<CsvFile*>(handle)->columns[i].dictionary.size();
}

const char* ydf_csv_col_dict_value(void* handle, int32_t i, int32_t j) {
  return static_cast<CsvFile*>(handle)->columns[i].dictionary[j].c_str();
}

}  // extern "C"
